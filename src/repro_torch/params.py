"""The weight bridge: a ``repro`` parameter tree, as numpy arrays, becomes the
port's parameter dict on a given device and dtype.

The JAX tree is ``unzip_params(model.init(key))`` with every leaf converted by
``np.asarray``: ``{"embedding": {...}, "blocks": {"0": {...}, ...},
"final_norm"}``, whose block leaves carry a leading ``n_blocks`` axis (layer
``b * scan_block + j`` is ``blocks[str(j)]`` at index ``b``).  bfloat16 leaves
(``ml_dtypes``) are reinterpreted bit for bit.  A requested ``dtype`` casts
every leaf except those the model keeps in float32 in any dtype (the Mamba2
layer's ``A_log``, ``D`` and ``dt_bias``).
"""
from __future__ import annotations


import numpy as np
import torch

from repro_torch.configs.base import ArchConfig


def to_tensor(a, device="cpu", dtype=None):
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


FP32_LEAVES = ("A_log", "D", "dt_bias")


def _map(tree, fn, name=""):
    if isinstance(tree, dict):
        return {k: _map(v, fn, k) for k, v in tree.items()}
    return fn(tree, name)


def from_jax_tree(tree, cfg, device="cpu",
                  dtype=None):
    """Convert a numpy ``repro`` parameter tree into the port's layout."""
    def conv(a, name=""):
        return to_tensor(a, device, None if name in FP32_LEAVES else dtype)

    sb = cfg.scan_block
    layers = [_map(tree["blocks"][str(j)], lambda a, name, b=b: conv(a[b], name))
              for b in range(cfg.n_layers // sb) for j in range(sb)]
    return {"embedding": _map(tree["embedding"], conv), "layers": layers,
            "final_norm": conv(tree["final_norm"])}
