"""Config registry: ``get_config("<arch-id>")`` and reduced test variants.

Every architecture of ``repro``: the dense decoders (qwen3-1.7b, llama2-7b,
qwen2.5-14b, starcoder2-7b, h2o-danube-3-4b), the MoE decoders
(qwen3-moe-30b-a3b, mixtral-8x7b), mamba2-2.7b (SSM), jamba-1.5-large-398b
(hybrid: Mamba2 and attention layers, MoE on every second),
internvl2-1b (a vision frontend stub) and seamless-m4t-large-v2
(encoder-decoder, an audio frontend stub).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import (SHAPES, ArchConfig, FrontendConfig, MoEConfig,
                                      ShapeConfig, SSMConfig, shape_applicable)
from repro_torch.configs.h2o_danube_3_4b import CONFIG as _danube
from repro_torch.configs.internvl2_1b import CONFIG as _internvl2
from repro_torch.configs.jamba_1_5_large_398b import CONFIG as _jamba
from repro_torch.configs.llama2_7b import CONFIG as _llama2
from repro_torch.configs.mamba2_2_7b import CONFIG as _mamba2
from repro_torch.configs.mixtral_8x7b import CONFIG as _mixtral
from repro_torch.configs.qwen2_5_14b import CONFIG as _qwen25
from repro_torch.configs.qwen3_1_7b import CONFIG as _qwen3
from repro_torch.configs.qwen3_moe_30b_a3b import CONFIG as _qwen3moe
from repro_torch.configs.seamless_m4t_large_v2 import CONFIG as _seamless
from repro_torch.configs.starcoder2_7b import CONFIG as _starcoder2

ARCHS: Dict[str, ArchConfig] = {c.name: c for c in [_mamba2, _qwen3, _qwen25, _starcoder2,
                                                    _danube, _internvl2, _jamba, _mixtral,
                                                    _qwen3moe, _seamless, _llama2]}
# the ten architectures of the dry run (llama2-7b is the paper's own extra)
ASSIGNED = ["mamba2-2.7b", "qwen3-1.7b", "qwen2.5-14b", "starcoder2-7b", "h2o-danube-3-4b",
            "internvl2-1b", "jamba-1.5-large-398b", "mixtral-8x7b", "qwen3-moe-30b-a3b",
            "seamless-m4t-large-v2"]


def get_config(name):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def reduced_config(name):
    """Tiny same-family variant for CPU tests (the rules of
    ``repro.configs.reduced_config`` for a dense decoder, MoE, a hybrid
    interleave, a sliding window, an SSM stack, a frontend and an encoder)."""
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
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(n_experts=min(cfg.moe.n_experts, 4), top_k=min(cfg.moe.top_k, 2),
                              d_ff_expert=256, every_n=cfg.moe.every_n)
        if cfg.family == "moe":
            kw["d_ff"] = 256
    if cfg.frontend is not None:
        kw["frontend"] = FrontendConfig(kind=cfg.frontend.kind, n_tokens=8)
    if cfg.n_encoder_layers > 0:
        kw["n_encoder_layers"] = min(cfg.n_encoder_layers, 2)
    if cfg.attn_period > 0:
        kw.update(attn_period=2, n_layers=4, scan_block=2)
    if cfg.sliding_window is not None:
        kw["sliding_window"] = 16
    return dataclasses.replace(cfg, **kw)


__all__ = ["ARCHS", "ASSIGNED", "SHAPES", "ArchConfig", "FrontendConfig", "MoEConfig",
           "SSMConfig", "ShapeConfig", "get_config", "reduced_config", "shape_applicable"]
