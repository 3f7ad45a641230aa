"""Layer walkers for attention+MLP and Mamba2 stacks (a port of the dense
and SSM paths of ``repro.models.transformer``).

The JAX package stacks layer parameters and scans over them; here the stack
is a Python list of per-layer parameter dicts and a loop.  A layer holds
``attn`` or ``mamba`` (per ``cfg.layer_kinds()``) and, when ``d_ff > 0``,
an MLP.
"""
from __future__ import annotations


import torch

from repro_torch.models import attention as attn
from repro_torch.models import ssm
from repro_torch.models.layers import apply_mlp, init_mlp, rms_norm


def check_supported(cfg):
    """Raise for every layer kind this port does not run yet, naming its item."""
    if cfg.moe is not None:
        raise NotImplementedError(f"{cfg.name}: MoE layers are not ported yet (ROADMAP M9)")
    if cfg.is_encdec or cfg.frontend is not None:
        raise NotImplementedError(f"{cfg.name}: enc-dec and frontend models are not "
                                  "ported yet (ROADMAP M9)")
    if cfg.qkv_bias or (cfg.n_heads >= 16 and cfg.n_heads % 16):
        raise NotImplementedError(f"{cfg.name}: QKV bias and padded heads are not "
                                  "ported yet (ROADMAP M9)")


def init_layer(gen, cfg, kind, dtype, device):
    ones = torch.ones(cfg.d_model, dtype=dtype, device=device)
    layer = {"norm1": ones}
    if kind == "attn":
        layer["attn"] = attn.init_attention(gen, cfg, dtype, device)
    else:
        layer["mamba"] = ssm.init_mamba(gen, cfg, dtype, device)
    if cfg.d_ff > 0:
        layer["norm2"] = ones.clone()
        layer["mlp"] = init_mlp(gen, cfg, cfg.d_ff, dtype, device)
    return layer


def _apply_ffn(layer, cfg, x):
    if "mlp" in layer:
        return x + apply_mlp(layer["mlp"], cfg, rms_norm(x, layer["norm2"], cfg.norm_eps))
    return x


def block_prefill(layer, cfg, x, positions):
    """One layer of prefill: returns (x, what seeds its cache): (k, v) for
    attention, (conv, state) for a Mamba2 layer."""
    h = rms_norm(x, layer["norm1"], cfg.norm_eps)
    if "attn" in layer:
        out, new = attn.attention_prefill(layer["attn"], cfg, h, positions)
    else:
        out, new = ssm.mamba_prefill(layer["mamba"], cfg, h)
    return _apply_ffn(layer, cfg, x + out), new


def block_decode(layer, cfg, x, cache,
                 cache_len, block_tables=None):
    """One layer of a T-token decode step; its cache views update in place."""
    h = rms_norm(x, layer["norm1"], cfg.norm_eps)
    if "attn" in layer:
        out = attn.attention_decode(layer["attn"], cfg, h, cache, cache_len, block_tables)
    else:
        out = ssm.mamba_decode(layer["mamba"], cfg, h, cache)
    return _apply_ffn(layer, cfg, x + out)
