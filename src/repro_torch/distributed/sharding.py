"""Logical-axis sharding on a ``torch.distributed`` DeviceMesh (a port of
``repro.distributed.sharding``).

A parameter's logical axes name what each dimension holds ("embed",
"heads", "experts", ...).  A rules table maps logical names to mesh axes;
:func:`logical_to_spec` resolves a parameter's axes into a spec for a mesh:
a tuple with one entry a tensor dimension, ``None``, one mesh axis or a
tuple of mesh axes (major to minor), trailing ``None``s dropped, as JAX's
``PartitionSpec`` holds them.  Mesh axes are those of the reference:

``pod``    cross-pod data parallelism (multi-pod meshes only)
``data``   data parallelism, FSDP
``model``  experts, heads, mlp, vocab, and the decode KV cache's sequence

:func:`use_mesh` is the port's ``with mesh:``.  Under a mesh every tensor a
rank holds is its own shard (:func:`shard_params`, :func:`local_shape`): its
data shard's rows of the activations and caches, its slots of a
sequence-sharded cache, and under :data:`INFERENCE_RULES` its slices of the
weights on "model" (heads, kv, mlp, vocab, experts, the Mamba2 inner
channels); the layers run tensor parallel on those slices
(``distributed.collectives``).

Left out: the reference's ``P`` leaf class (the port's parameter dicts
carry no axes; :func:`param_axes` gives them) and ``constraint``, a GSPMD
layout hint inside the reference's model code: the port's layers issue
their collectives themselves.  Query heads the reference pads for its
16-way model axis (``ArchConfig.padded_heads``) are split as the padded
slots fall (:func:`head_range`): a rank holds the real heads among its
slots.
"""
from __future__ import annotations

import contextlib

from torch.utils import _pytree as pytree

# Order matters: earlier entries win contested mesh axes.
DEFAULT_RULES = (
    ("batch", ("pod", "data")),
    ("ctx", ("data",)),        # context/sequence parallel activations
    ("kv_seq", ("model",)),    # decode KV cache sequence dim (flash-decode)
    ("experts", ("model",)),
    ("heads", ("model",)),
    ("kv", ("model",)),
    ("mlp", ("model",)),
    ("vocab", ("model",)),
    ("embed", ("data",)),      # FSDP weight sharding
    ("conv", ("model",)),      # mamba conv channels
    ("inner", ("model",)),     # mamba d_inner
)
# FSDP across pods as well: weights and optimizer state scale with every device
POD_FSDP_RULES = tuple((name, ("pod", "data") if name == "embed" else axes)
                       for name, axes in DEFAULT_RULES)
# serving: no FSDP on "embed" (a gather of every weight every decode step)
INFERENCE_RULES = tuple((name, () if name == "embed" else axes) for name, axes in DEFAULT_RULES)
# ZeRO-1 for small models: weights replicated over data, optimizer state FSDP
ZERO1_PARAM_RULES = INFERENCE_RULES
ZERO1_WEIGHT_BYTES_LIMIT = 8e9  # replicated bf16 weights budget per device

_ACTIVE = {"rules": DEFAULT_RULES, "mesh": None}


@contextlib.contextmanager
def _swap(key, value):
    prev, _ACTIVE[key] = _ACTIVE[key], value
    try:
        yield value
    finally:
        _ACTIVE[key] = prev


def use_rules(rules):
    """Context manager: the rules :func:`shard_params` uses by default."""
    return _swap("rules", rules)


def active_rules():
    return _ACTIVE["rules"]


def use_mesh(mesh):
    """Context manager: ``mesh`` is the active mesh (the reference's ``with
    mesh:``).  A mapping {axis: size} stands in for a mesh where only sizes
    are read (cache shapes, specs)."""
    return _swap("mesh", mesh)


def current_mesh():
    return _ACTIVE["mesh"]


def data_shards():
    """Data-parallel shards of the active mesh (pod x data); 1 without one."""
    sizes = mesh_sizes(current_mesh() or {})
    return sizes.get("pod", 1) * sizes.get("data", 1)


def mesh_sizes(mesh):
    """{axis name: size} of a DeviceMesh, in the mesh's order, or the mapping
    itself."""
    return mesh if isinstance(mesh, dict) else dict(zip(mesh.mesh_dim_names, mesh.shape,
                                                        strict=True))


def make_mesh(shape, axis_names=("data", "model"), device="cuda"):
    """A DeviceMesh whose dimensions are the reference's mesh axes, over the
    default process group (NCCL on the card, where ``init_device_mesh``
    starts it; the tests start gloo first and pass ``device="cpu"``)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device, tuple(shape), mesh_dim_names=tuple(axis_names))


def logical_to_spec(axes, mesh, rules=DEFAULT_RULES, shape=None):
    """Resolve logical axes into a spec for ``mesh`` (a DeviceMesh or a
    mapping of sizes): mesh axes absent from the mesh are dropped, a mesh
    axis already used by an earlier dimension is skipped, and a dimension
    smaller than its shard count or not divisible by it is replicated."""
    sizes, lookup = mesh_sizes(mesh), dict(rules)
    used, out = set(), []
    for i, name in enumerate(axes):
        mesh_axes = [ax for ax in lookup.get(name, ()) if ax in sizes and ax not in used]
        n = 1
        for ax in mesh_axes:
            n *= sizes[ax]
        if not mesh_axes or shape is not None and (shape[i] < n or shape[i] % n):
            out.append(None)
            continue
        used.update(mesh_axes)
        out.append(tuple(mesh_axes) if len(mesh_axes) > 1 else mesh_axes[0])
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def batch_axes(batch):
    """Logical axes of a batch's leaves (tensors or shapes): rows on "batch"."""
    return {k: ("batch",) + (None,) * (len(getattr(v, "shape", v)) - 1) for k, v in batch.items()}


# logical axes of the port's flat decode cache (the reference's ``cache_axes``
# for its keys): stacked leaves lead with their layer axis
CACHE_AXES = {
    "k": ("layer", "batch", "kv_seq", "kv", None), "v": ("layer", "batch", "kv_seq", "kv", None),
    "kv_pos": ("layer", "batch", "kv_seq"), "conv": ("layer", "batch", None, "conv"),
    "state": ("layer", "batch", "heads", None, None),
    "conv_all": ("layer", "batch", None, None, "conv"),
    "states_all": ("layer", "batch", None, "heads", None, None),
    "cross_k": ("layer", "batch", None, "kv", None),
    "cross_v": ("layer", "batch", None, "kv", None),
    "len": ("batch",), "mem_len": ("batch",), "mem_pos": ("batch", None),
}


def axes_leaves(axes_tree):
    """The axes tuples of a tree of them, in leaf order."""
    return pytree.tree_flatten(axes_tree, is_leaf=lambda x: isinstance(x, tuple))[0]


def stack_axes(axes):
    """Logical axes of a layer-stacked parameter."""
    return ("layer", *axes)


def tree_specs(axes_tree, values_tree, mesh, rules=DEFAULT_RULES):
    """Specs of a parameter tree, leaf for leaf, from each leaf's shape."""
    values, spec = pytree.tree_flatten(values_tree)
    return pytree.tree_unflatten([logical_to_spec(a, mesh, rules, v.shape) for a, v in
                                  zip(axes_leaves(axes_tree), values, strict=True)], spec)


def local_shape(shape, spec, sizes, coord=None):
    """One rank's shard shape of a tensor of ``shape`` under ``spec``, from a
    mapping of mesh sizes; with ``coord`` ({axis: index}) also where each
    dimension's shard starts: (shape, starts)."""
    out, starts = list(shape), [0] * len(shape)
    for d, entry in enumerate(spec):
        i, n = 0, 1
        for ax in (entry,) if isinstance(entry, str) else entry or ():
            i, n = i * sizes[ax] + (coord or {}).get(ax, 0), n * sizes[ax]
        out[d] //= n
        starts[d] = i * out[d]
    return (tuple(out), starts) if coord is not None else tuple(out)


def head_range(cfg, n, j):
    """Query heads [h0, h1) of rank j of a "model" axis of n: the real heads
    among the padded slots [j Hp / n, (j + 1) Hp / n) (every slot is real
    where the reference pads nothing); all heads where the slots do not
    split."""
    Hp, Gp = cfg.padded_heads, cfg.padded_group
    if n == 1 or Hp < n or Hp % n:
        return 0, cfg.n_heads
    G = cfg.n_heads // cfg.n_kv_heads

    def real(s):  # real heads before slot s
        return s // Gp * G + min(s % Gp, G)

    return real(j * Hp // n), real((j + 1) * Hp // n)


def _head_leaves(cfg, *trees):
    """((each tree's attention dict), leaf name, the query heads' dimension)
    of every attention leaf split by query heads."""
    for dicts in zip(*(t["layers"] + t.get("encoder", []) for t in trees), strict=True):
        for k in ("attn", "cross"):
            for name, d in (("wq", 1), ("wo", 0), ("bq", 0)):
                if name in dicts[0].get(k, ()):
                    yield [t[k] for t in dicts], name, d


def param_specs(axes_tree, params, mesh, rules=None, cfg=None):
    """Each leaf's spec as :func:`shard_params` resolves it under ``rules``
    (the active rules by default); with ``cfg``, where the query heads split
    over "model" (:func:`head_range`: as the reference pads them), their
    dimension on "model".  The one place a parameter's layout is decided."""
    specs = tree_specs(axes_tree, params, mesh, rules or active_rules())
    if cfg is not None and head_range(cfg, mesh_sizes(mesh).get("model", 1), 0)[1] < cfg.n_heads:
        for (spec,), name, d in _head_leaves(cfg, specs):
            spec[name] = (*spec[name], *(None,) * d)[:d] + ("model",) + spec[name][d + 1:]
    return specs


def mesh_coord(mesh):
    """{axis: this rank's index on it} of a DeviceMesh; rank 0's (all 0)
    for a mapping of sizes."""
    sizes = mesh_sizes(mesh)
    return dict(zip(sizes, [0] * len(sizes) if isinstance(mesh, dict) else mesh.get_coordinate(),
                    strict=True))


def piece_bounds(params, axes_tree, mesh, rules=None, cfg=None):
    """Where this rank's piece of each leaf lies in the whole leaf, as
    :func:`shard_params` cuts it, in leaf order: (starts, shape) a leaf.
    With ``cfg``, the query heads of a config whose heads the reference pads
    follow :func:`head_range`."""
    sizes, coord = mesh_sizes(mesh), mesh_coord(mesh)
    leaves, spec = pytree.tree_flatten(params)
    out = [(starts, list(shape)) for shape, starts in (
        local_shape(v.shape, s, sizes, coord) for v, s in zip(
            leaves, axes_leaves(param_specs(axes_tree, params, mesh, rules, cfg)), strict=True))]
    if cfg is not None and cfg.padded_heads != cfg.n_heads:  # the padded slots' real heads
        h0, h1 = head_range(cfg, sizes.get("model", 1), coord.get("model", 0))
        for (idx,), name, d in _head_leaves(cfg, pytree.tree_unflatten(list(range(len(leaves))),
                                                                        spec)):
            out[idx[name]][0][d], out[idx[name]][1][d] = h0, h1 - h0
    return out


def shard_params(params, axes_tree, mesh, rules=None, cfg=None):
    """This rank's shard of every leaf under ``rules`` (the active rules by
    default): each leaf, whole on every rank, narrowed on each sharded
    dimension to the piece of the rank's mesh coordinate (rank 0's for a
    mapping of sizes; a copy where it is smaller, no collective;
    :func:`piece_bounds`); meta tensors give meta shards."""
    leaves, spec = pytree.tree_flatten(params)
    out = []
    for v, (starts, shape) in zip(leaves, piece_bounds(params, axes_tree, mesh, rules, cfg),
                                  strict=True):
        piece = v
        for d, (a, n) in enumerate(zip(starts, shape, strict=True)):
            piece = piece.narrow(d, a, n)
        out.append(piece.clone() if piece.numel() < v.numel() else piece)
    return pytree.tree_unflatten(out, spec)


_ATTN = {"wq": "embed heads -", "wk": "embed kv -", "wv": "embed kv -", "wo": "heads - embed",
         "bq": "heads -", "bk": "kv -", "bv": "kv -", "q_norm": "-", "k_norm": "-"}
_AXES = {  # a module's leaves: their logical axes, "-" for None
    "attn": _ATTN, "cross": _ATTN,
    "mlp": {"wi": "embed mlp", "wg": "embed mlp", "wo": "mlp embed"},
    "moe": {"router": "embed -", "wi": "experts embed mlp", "wg": "experts embed mlp",
            "wo": "experts mlp embed"},
    "mamba": {"in_z": "embed inner", "in_xbc": "embed conv", "in_dt": "embed heads",
              "conv_w": "- conv", "conv_b": "conv", "A_log": "heads", "D": "heads",
              "dt_bias": "heads", "norm": "inner", "out_proj": "inner embed"},
    "embedding": {"table": "vocab embed", "head": "embed vocab"},
}


def param_axes(params):
    """The logical axes of every leaf of the port's parameter tree, as the
    reference's ``init_*`` functions give them (a layer's leaves without the
    leading "layer" that :func:`stack_axes` adds); RMSNorm scales are
    ("embed",)."""
    leaves, spec = pytree.tree_flatten_with_path(params)

    def axes(path):
        *_, owner, name = (None, *(getattr(k, "key", None) for k in path))
        names = _AXES[owner][name] if owner in _AXES else "embed"
        return tuple(None if a == "-" else a for a in names.split())

    return pytree.tree_unflatten([axes(path) for path, _ in leaves], spec)
