"""Shared model building blocks (a port of ``repro.models.layers``).

Functions on tensors over a parameter dict.  Weights keep the JAX layout:
a dense kernel is (in_dim, *out_dims), so ``x @ w.view(in_dim, -1)``.

Under a mesh a layer takes this rank's weight shards (``shard_params``) and
learns its layout from their shapes: the MLP's ``wi`` (and gate) column
parallel on "mlp" and ``wo`` row parallel, summed over "model"; the
embedding and the head vocab parallel (a masked lookup summed over
"model"; logits gathered).  A dimension the spec holds whole is used whole.
Under autograd a whole activation enters each column-parallel product
through ``model_copy``; under FSDP (training, "embed" on "data") each
weight is gathered where it is used (``gather_weights``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.collectives import (fsdp_gather, model_copy, model_gather,
                                                 model_rank, model_split, model_sum)
from repro_torch.distributed.sharding import current_mesh


def dense_init(gen, in_dim, out_dims, dtype, device,
               scale=None):
    """Truncated normal on [-2, 2] times ``scale`` (default fan-in 1/sqrt(in)),
    the distribution of ``repro.models.layers.dense_init``."""
    out_dims = (out_dims,) if isinstance(out_dims, int) else tuple(out_dims)
    w = torch.empty((in_dim, *out_dims), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    std = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    return (w * std).to(dtype)


def rms_norm(x, w, eps):
    """RMSNorm in float32, cast back to x's dtype."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def rope(x, positions, theta):
    """Rotary embedding in float32.  x: (..., S, H, D), positions: (..., S)."""
    D = x.shape[-1]
    half = D // 2
    freq = torch.exp(-math.log(theta)
                     * torch.arange(half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., None].float() * freq
    cos, sin = angles.cos()[..., None, :], angles.sin()[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:2 * half].float()
    parts = [x1 * cos - x2 * sin, x2 * cos + x1 * sin]
    if D > 2 * half:  # odd head_dim: the trailing lane passes through
        parts.append(x[..., 2 * half:].float())
    return torch.cat(parts, -1).to(x.dtype)


def init_mlp(gen, cfg, d_ff, dtype, device):
    d = cfg.d_model
    p = {"wi": dense_init(gen, d, d_ff, dtype, device)}
    if cfg.mlp_type == "swiglu":
        p["wg"] = dense_init(gen, d, d_ff, dtype, device)
    p["wo"] = dense_init(gen, d_ff, d, dtype, device)
    return p


def gather_weights(tree):
    """FSDP: ``tree``'s leaves whole, each gathered over "data" on the
    dimensions the train step's layout gives it (``fsdp_dims``), inside a
    layer's remat, so the whole weight lives for the layer only; ``tree`` as
    it is otherwise."""
    if current_mesh() is None:
        return tree

    def whole(w):
        for d in getattr(w, "fsdp_dims", ()):
            w = fsdp_gather(w, d)
        return w

    return torch.utils._pytree.tree_map(whole, tree)


def apply_mlp(p, cfg, x):
    x = model_copy(x, model_split(p["wi"].shape[1], cfg.d_ff)[2])
    h = x @ p["wi"]
    h = F.silu(x @ p["wg"]) * h if cfg.mlp_type == "swiglu" else F.gelu(h, approximate="tanh")
    return model_sum(h @ p["wo"], model_split(p["wo"].shape[0], cfg.d_ff)[2])


def init_embedding(gen, cfg, dtype, device):
    """Table (and untied head) at ``cfg.padded_vocab`` rows."""
    vp = cfg.padded_vocab
    table = torch.empty(vp, cfg.d_model, dtype=torch.float32, device=device)
    table.normal_(0.0, 1.0, generator=gen)
    out = {"table": (table * 0.02).to(dtype)}
    if not cfg.tie_embeddings:
        out["head"] = dense_init(gen, cfg.d_model, vp, dtype, device, scale=0.02)
    return out


def embed_tokens(p, tokens, vocab=None):
    """The table's rows of ``tokens``; a table of fewer rows than ``vocab``
    is this rank's vocab shard: the rows it holds, zeros for the others,
    summed over "model"."""
    table = p["table"]
    V = table.shape[0]
    _, j, sharded = model_split(V, vocab or V)
    if not sharded:
        return table[tokens]
    idx = tokens - j * V
    held = (idx >= 0) & (idx < V)
    return model_sum(table[idx.clamp(0, V - 1)] * held[..., None].to(table.dtype), True)


def unembed(p, x, tie, vocab_size=None, gather=True):
    """Logits of x; a vocab shard's columns gathered over "model" (or, not
    ``gather``, this rank's columns, padding masked: training's
    vocab-parallel cross-entropy)."""
    w = p["table"].T if tie else p["head"]
    sharded = vocab_size is not None and model_split(w.shape[1], -(-vocab_size // 256) * 256)[2]
    logits = model_copy(x, sharded) @ w
    if sharded and gather:
        logits = model_gather(logits, -1)  # vocab parallel
    vp = logits.shape[-1]
    first = model_rank()[1] * vp if sharded and not gather else 0  # this rank's columns
    if vocab_size is not None and vocab_size < first + vp:
        # padded vocab columns are never sampled
        pad = torch.arange(first, first + vp, device=logits.device) >= vocab_size
        logits = logits.masked_fill(pad, torch.finfo(logits.dtype).min)
    return logits
