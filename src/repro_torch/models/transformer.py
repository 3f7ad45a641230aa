"""Layer walkers for attention+MLP stacks (a port of the dense path of
``repro.models.transformer``).

The JAX package stacks layer parameters and scans over them; here the stack
is a Python list of per-layer parameter dicts and a loop.  Attention caches
roll back by pointer alone, so the reference's ``commit_block_cache`` (which
only touches SSM state) has no counterpart yet.
"""
from __future__ import annotations


import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import apply_mlp, init_mlp, rms_norm


def check_supported(cfg):
    """Raise for every layer kind this slice does not run, naming its item."""
    if any(kind != "attn" for kind in cfg.layer_kinds()):
        raise NotImplementedError(f"{cfg.name}: SSM layers are not ported yet "
                                  "(ROADMAP M9, with the ssd_scan kernel K4)")
    if cfg.moe is not None:
        raise NotImplementedError(f"{cfg.name}: MoE layers are not ported yet (ROADMAP M9)")
    if cfg.is_encdec or cfg.frontend is not None:
        raise NotImplementedError(f"{cfg.name}: enc-dec and frontend models are not "
                                  "ported yet (ROADMAP M9)")
    if cfg.qkv_bias or (cfg.n_heads >= 16 and cfg.n_heads % 16):
        raise NotImplementedError(f"{cfg.name}: QKV bias and padded heads are not "
                                  "ported yet (ROADMAP M9)")


def init_layer(gen, cfg, dtype, device):
    ones = torch.ones(cfg.d_model, dtype=dtype, device=device)
    layer = {"norm1": ones, "attn": attn.init_attention(gen, cfg, dtype, device)}
    if cfg.d_ff > 0:
        layer["norm2"] = ones.clone()
        layer["mlp"] = init_mlp(gen, cfg, cfg.d_ff, dtype, device)
    return layer


def _apply_ffn(layer, cfg, x):
    if "mlp" in layer:
        return x + apply_mlp(layer["mlp"], cfg, rms_norm(x, layer["norm2"], cfg.norm_eps))
    return x


def block_prefill(layer, cfg, x, positions):
    """One layer of prefill: returns (x, (k, v)) for cache seeding."""
    out, kv = attn.attention_prefill(layer["attn"], cfg,
                                     rms_norm(x, layer["norm1"], cfg.norm_eps), positions)
    return _apply_ffn(layer, cfg, x + out), kv


def block_decode(layer, cfg, x, cache,
                 cache_len, block_tables=None):
    """One layer of a T-token decode step; its cache views update in place."""
    out = attn.attention_decode(layer["attn"], cfg, rms_norm(x, layer["norm1"], cfg.norm_eps),
                                cache, cache_len, block_tables)
    return _apply_ffn(layer, cfg, x + out)
