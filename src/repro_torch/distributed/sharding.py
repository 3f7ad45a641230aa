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

:func:`use_mesh` is the port's ``with mesh:``: the context-parallel decode
(``models.attention``) and the expert-parallel MoE (``models.moe``) run
when a mesh is active.  Under a mesh every tensor a rank holds is its own
shard: its data shard's rows of the activations and caches, its slots of a
sequence-sharded cache, its slices of the expert stacks
(:func:`shard_params`).

Left out: the reference's ``P`` leaf class (the port's parameter dicts
carry no axes; :func:`param_axes` gives them) and ``constraint``, a GSPMD
layout hint inside the reference's model code, which an eager port whose
kernels take plain tensors has no use for.  Without it, weights sharded on
"heads" or "mlp" would need tensor-parallel layers, which the port does not
have.  The reference's expert-parallel layout is what
:data:`INFERENCE_RULES` gives a MoE layer's leaves; the rest stays whole on
each rank.
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


def placements(spec, mesh):
    """DTensor placements of a spec: ``Shard(d)`` on each mesh dimension
    that tensor dimension d uses (a tuple entry over several, in mesh
    order), ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard

    def dim(ax):
        return next((d for d, e in enumerate(spec) if ax == e or isinstance(e, tuple) and ax in e),
                    None)

    return [Replicate() if dim(ax) is None else Shard(dim(ax)) for ax in mesh.mesh_dim_names]


def _leaves(axes_tree):
    return pytree.tree_flatten(axes_tree, is_leaf=lambda x: isinstance(x, tuple))[0]


def stack_axes(axes):
    """Logical axes of a layer-stacked parameter."""
    return ("layer", *axes)


def tree_specs(axes_tree, values_tree, mesh, rules=DEFAULT_RULES):
    """Specs of a parameter tree, leaf for leaf, from each leaf's shape."""
    values, spec = pytree.tree_flatten(values_tree)
    return pytree.tree_unflatten([logical_to_spec(a, mesh, rules, v.shape) for a, v in
                                  zip(_leaves(axes_tree), values, strict=True)], spec)


def shard_params(params, axes_tree, mesh, rules=None):
    """This rank's shard of every leaf (plain tensors), under ``rules`` (the
    active rules by default): each leaf, whole on every rank, goes through
    ``distribute_tensor`` with its spec's placements, each rank taking its
    own piece (no collective), and comes back as that piece."""
    from torch.distributed.tensor import distribute_tensor

    def piece(v, spec):
        return distribute_tensor(v, mesh, placements(spec, mesh), src_data_rank=None).to_local()

    return pytree.tree_map(piece, params, tree_specs(axes_tree, params, mesh,
                                                     rules or active_rules()))


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
