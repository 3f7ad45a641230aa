"""Shared model building blocks (a port of ``repro.models.layers``).

Functions on tensors over a parameter dict.  Weights keep the JAX layout:
a dense kernel is (in_dim, *out_dims), so ``x @ w.view(in_dim, -1)``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig


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


def apply_mlp(p, cfg, x):
    h = x @ p["wi"]
    h = F.silu(x @ p["wg"]) * h if cfg.mlp_type == "swiglu" else F.gelu(h, approximate="tanh")
    return h @ p["wo"]


def init_embedding(gen, cfg, dtype, device):
    """Table (and untied head) at ``cfg.padded_vocab`` rows."""
    vp = cfg.padded_vocab
    table = torch.empty(vp, cfg.d_model, dtype=torch.float32, device=device)
    table.normal_(0.0, 1.0, generator=gen)
    out = {"table": (table * 0.02).to(dtype)}
    if not cfg.tie_embeddings:
        out["head"] = dense_init(gen, cfg.d_model, vp, dtype, device, scale=0.02)
    return out


def embed_tokens(p, tokens):
    return p["table"][tokens]


def unembed(p, x, tie, vocab_size=None):
    logits = x @ p["table"].T if tie else x @ p["head"]
    vp = logits.shape[-1]
    if vocab_size is not None and vocab_size < vp:
        # padded vocab columns are never sampled
        pad = torch.arange(vp, device=logits.device) >= vocab_size
        logits = logits.masked_fill(pad, torch.finfo(logits.dtype).min)
    return logits
