"""Config registry: ``get_config("<arch-id>")`` and reduced test variants.

Only qwen3-1.7b is ported so far; the other architectures of ``repro``
arrive with their model code (ROADMAP, M9).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.qwen3_1_7b import CONFIG as _qwen3

ARCHS: Dict[str, ArchConfig] = {c.name: c for c in [_qwen3]}


def get_config(name):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def reduced_config(name):
    """Tiny same-family variant for CPU tests (the rules of
    ``repro.configs.reduced_config`` for a dense decoder)."""
    cfg = get_config(name)
    return dataclasses.replace(
        cfg, n_layers=min(cfg.n_layers, 4), d_model=128, vocab_size=512,
        head_dim=32, scan_block=1, n_heads=4,
        n_kv_heads=max(1, 4 * cfg.n_kv_heads // max(cfg.n_heads, 1)), d_ff=256,
    )


__all__ = ["ARCHS", "ArchConfig", "get_config", "reduced_config"]
