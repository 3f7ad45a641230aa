"""Architecture configuration (the dense and SSM parts of ``repro.configs.base``).

Every architecture is an :class:`ArchConfig`: pure frozen data with the same
fields and defaults as the reference.  The port serves dense attention+MLP
decoders and Mamba2 (SSD) stacks; the ``moe`` and ``frontend`` fields stay
so that a config naming them is refused by name (``models.transformer.
check_supported``) rather than misread.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD — state space duality) configuration."""

    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    d_conv: int = 4
    chunk_size: int = 256
    n_groups: int = 1

    def d_inner(self, d_model):
        return self.expand * d_model

    def n_heads(self, d_model):
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | ssm | moe | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None
    attn_period: int = 0
    mlp_type: str = "swiglu"  # swiglu | gelu
    moe: Optional[Any] = None
    ssm: Optional[SSMConfig] = None
    frontend: Optional[Any] = None
    n_encoder_layers: int = 0
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    optimizer: str = "adamw"
    remat_policy: str = "minimal"
    scan_block: int = 1
    source: str = ""
    notes: str = ""

    @property
    def padded_vocab(self):
        """Vocab rounded up to a multiple of 256 (padded logits are masked)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def is_encdec(self):
        return self.n_encoder_layers > 0

    def layer_kinds(self):
        """Per-layer kinds: 'attn' or 'ssm'."""
        if self.family == "ssm":
            return ("ssm",) * self.n_layers
        p = self.attn_period
        if self.family == "hybrid" and p > 0:
            return tuple("attn" if i % p == p - 1 else "ssm" for i in range(self.n_layers))
        return ("attn",) * self.n_layers

    def n_active_params(self):
        """Parameters per token (embedding, attention or SSM mixer, MLP and
        norms), as ``repro``'s ``_count_params`` gives for a model without MoE."""
        d, hd = self.d_model, self.head_dim
        attn = 2 * d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
        ssm = 0
        if self.ssm is not None:
            s = self.ssm
            d_in, nh, gn = s.d_inner(d), s.n_heads(d), 2 * s.n_groups * s.d_state
            ssm = d * (2 * d_in + gn + nh) + s.d_conv * (d_in + gn) + d_in * d + 3 * nh
        mlp = (3 if self.mlp_type == "swiglu" else 2) * d * self.d_ff
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        mixers = sum(attn if kind == "attn" else ssm for kind in self.layer_kinds())
        return embed + mixers + self.n_layers * (mlp + 2 * d)

    n_params = n_active_params  # without MoE every parameter is active
