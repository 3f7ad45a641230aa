"""Config registry: ``get_config("<arch-id>")`` and reduced test variants.

qwen3-1.7b and llama2-7b (dense) and mamba2-2.7b (SSM) are ported so far;
the other architectures of ``repro`` arrive with their model code (ROADMAP, M9).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import ArchConfig, SSMConfig
from repro_torch.configs.llama2_7b import CONFIG as _llama2
from repro_torch.configs.mamba2_2_7b import CONFIG as _mamba2
from repro_torch.configs.qwen3_1_7b import CONFIG as _qwen3

ARCHS: Dict[str, ArchConfig] = {c.name: c for c in [_mamba2, _qwen3, _llama2]}


def get_config(name):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def reduced_config(name):
    """Tiny same-family variant for CPU tests (the rules of
    ``repro.configs.reduced_config`` for a dense decoder and an SSM stack)."""
    cfg = get_config(name)
    kw = {"n_layers": min(cfg.n_layers, 4), "d_model": 128, "vocab_size": 512,
          "head_dim": 32, "scan_block": 1}
    if cfg.family == "ssm":
        kw.update(n_heads=0, n_kv_heads=0, d_ff=0)
    else:
        kw.update(n_heads=4, n_kv_heads=max(1, 4 * cfg.n_kv_heads // max(cfg.n_heads, 1)),
                  d_ff=256)
    if cfg.ssm is not None:
        kw["ssm"] = SSMConfig(d_state=16, head_dim=32, expand=2, d_conv=4, chunk_size=32)
    return dataclasses.replace(cfg, **kw)


__all__ = ["ARCHS", "ArchConfig", "SSMConfig", "get_config", "reduced_config"]
