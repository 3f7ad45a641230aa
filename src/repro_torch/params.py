"""The weight bridge: a ``repro`` parameter tree, as numpy arrays, becomes the
port's parameter dict on a given device and dtype.

The JAX tree is ``unzip_params(model.init(key))`` with every leaf converted by
``np.asarray``: ``{"embedding": {...}, "blocks": {"0": {...}, ...},
"final_norm"}`` (an encoder-decoder's also ``"encoder"``, stacked alike, and
``"enc_norm"``), whose block leaves carry a leading ``n_blocks`` axis (layer
``b * scan_block + j`` is ``blocks[str(j)]`` at index ``b``).  bfloat16 leaves
(``ml_dtypes``) are reinterpreted bit for bit.  A requested ``dtype`` casts
every leaf except those the model keeps in float32 in any dtype (the Mamba2
layer's ``A_log``, ``D`` and ``dt_bias``, and the MoE ``router``).  Where the reference pads query
heads (``ArchConfig.padded_heads``), the pad slots of ``wq``, ``bq`` and
``wo`` (self and cross attention) are dropped: the reference masks those heads to zero before ``wo``,
so the port's unpadded heads, in the order GQA's ``h // G`` expects, compute
the same function.  ``from_reference_state`` takes the same path for a
reference training checkpoint's parameters and optimizer state.  ``tree_map``
(PyTorch's pytree) and ``tree_items`` walk the port's trees (dicts, lists,
NamedTuples).
"""
from __future__ import annotations


import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.configs.base import ArchConfig


def tree_items(tree):
    """(path, leaf) pairs of a dict / list / NamedTuple tree, in ``tree_map``'s
    order; paths join dict keys, list indices and NamedTuple field names
    with "/" (as the reference's checkpoints name leaves)."""
    return [("/".join(str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))
                      for k in path), leaf)
            for path, leaf in pytree.tree_flatten_with_path(tree)[0]]


tree_map = pytree.tree_map


def to_tensor(a, device="cpu", dtype=None):
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype or a.dtype)
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


FP32_LEAVES = ("A_log", "D", "dt_bias", "router")


def _map(tree, fn, name=""):
    if isinstance(tree, dict):
        return {k: _map(v, fn, k) for k, v in tree.items()}
    return fn(tree, name)


def from_jax_tree(tree, cfg, device="cpu",
                  dtype=None):
    """Convert a numpy ``repro`` parameter tree into the port's layout."""
    def conv(a, name=""):
        return to_tensor(a, device, None if name in FP32_LEAVES else dtype)

    def stack(blocks, n_layers):
        sb = cfg.scan_block
        return [_map(blocks[str(j)], lambda a, name, b=b: conv(a[b], name))
                for b in range(n_layers // sb) for j in range(sb)]

    out = {"embedding": _map(tree["embedding"], conv),
           "layers": stack(tree["blocks"], cfg.n_layers), "final_norm": conv(tree["final_norm"])}
    if "encoder" in tree:  # an encoder-decoder's encoder stack
        out["encoder"] = stack(tree["encoder"], cfg.n_encoder_layers)
        out["enc_norm"] = conv(tree["enc_norm"])
    if cfg.padded_heads != cfg.n_heads:
        slot = torch.arange(cfg.padded_heads, device=device)
        real = slot[slot % cfg.padded_group < cfg.n_heads // cfg.n_kv_heads]
        for layer in out["layers"] + out.get("encoder", []):
            for p in (layer[k] for k in ("attn", "cross") if k in layer):
                p["wq"], p["wo"] = p["wq"].index_select(1, real), p["wo"].index_select(0, real)
                if "bq" in p:
                    p["bq"] = p["bq"].index_select(0, real)
    return out


def from_reference_state(leaves, cfg, device="cpu", dtype=None):
    """A reference training checkpoint's leaves ({"params/...", "opt/step",
    "opt/mu/...", "opt/nu/..."} of AdamW, or "opt/vr/...", "opt/vc/..." of
    adafloor: arrays or tensors) as the port's (parameters in ``dtype``,
    (step, mu, nu) or (step, vr, vc) in float32): the fields of the
    reference's ``AdamWState`` or ``AdafloorState``, leaf for leaf.
    Adafloor's (1,) placeholder of a block leaf is not stacked: each layer
    gets its own."""
    tree = {}
    for key, a in leaves.items():
        *path, last = key.split("/")
        node = tree
        for name in path:
            node = node.setdefault(name, {})
        node[last] = a
    opt = tree["opt"]
    names = ("mu", "nu") if "mu" in opt else ("vr", "vc")
    if "vc" in opt:
        n_blocks = cfg.n_layers // cfg.scan_block
        opt["vc"]["blocks"] = _map(opt["vc"]["blocks"], lambda a, _: np.broadcast_to(
            a, (n_blocks, 1)) if tuple(a.shape) == (1,) else a)
    return (from_jax_tree(tree["params"], cfg, device, dtype),
            (to_tensor(opt["step"]), *(from_jax_tree(opt[k], cfg, device) for k in names)))
