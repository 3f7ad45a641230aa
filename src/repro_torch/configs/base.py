"""Architecture configuration and the dry run's input shapes (a port of
``repro.configs.base``).

Every architecture is an :class:`ArchConfig`: pure frozen data with the same
fields and defaults as the reference: dense attention+MLP decoders,
mixture-of-experts decoders, Mamba2 (SSD) stacks, a decoder behind a vision
frontend stub and an encoder-decoder behind an audio frontend stub.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts configuration."""

    n_experts: int
    top_k: int
    d_ff_expert: int
    # Apply MoE every `every_n` layers (1 = every layer).  Jamba uses 2.
    every_n: int = 1
    # Router jitter / z-loss co-efficients (training only).
    router_z_loss: float = 1e-3
    load_balance_loss: float = 1e-2


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
class FrontendConfig:
    """Modality frontend STUB: the caller gives ``n_tokens`` precomputed
    embeddings a row, already projected to ``d_model`` (vision: patches
    prepended to the text; audio: the encoder's frames)."""

    kind: str  # "vision" | "audio"
    n_tokens: int = 256


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
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    frontend: Optional[FrontendConfig] = None
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
    def padded_heads(self):
        """The reference's query heads padded for its 16-way model axis: G is
        raised until ``K * G_pad`` is a multiple of 16 (40 -> 48 for
        qwen2.5-14b, 36 -> 48 for starcoder2-7b).  The port runs the unpadded model; the weight
        bridge drops the pad slots (``params.from_jax_tree``)."""
        H, K = self.n_heads, self.n_kv_heads
        if H == 0 or H < 16 or H % 16 == 0:
            return H
        G_pad = H // K
        while (K * G_pad) % 16:
            G_pad += 1
        return K * G_pad

    @property
    def padded_group(self):
        """Query slots per KV head in the padded, group-major layout: slot h
        holds a real head iff ``h % padded_group < n_heads // n_kv_heads``."""
        return self.padded_heads // self.n_kv_heads if self.n_kv_heads else 0

    @property
    def padded_vocab(self):
        """Vocab rounded up to a multiple of 256 (padded logits are masked)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def supports_long_context(self):
        """Decode memory bounded in the context: an SSM or hybrid stack, or a
        sliding window (``long_500k`` is skipped for the others)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window is not None

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

    def moe_layer_mask(self):
        """True for layers whose MLP is MoE."""
        if self.moe is None:
            return (False,) * self.n_layers
        n = self.moe.every_n
        return tuple(i % n == n - 1 for i in range(self.n_layers))

    def _count_params(self, active_only):
        """``repro``'s ``_count_params``: embedding, attention or SSM mixer,
        MLP (MoE: the router and the experts, only ``top_k`` of them when
        ``active_only``) and norms; an encoder-decoder adds its encoder
        layers and each decoder layer's cross attention and its norm."""
        d, hd = self.d_model, self.head_dim
        attn = 2 * d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
        ssm = 0
        if self.ssm is not None:
            s = self.ssm
            d_in, nh, gn = s.d_inner(d), s.n_heads(d), 2 * s.n_groups * s.d_state
            ssm = d * (2 * d_in + gn + nh) + s.d_conv * (d_in + gn) + d_in * d + 3 * nh
        per_ff = (3 if self.mlp_type == "swiglu" else 2) * d
        total = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        for kind, is_moe in zip(self.layer_kinds(), self.moe_layer_mask(), strict=True):
            total += (attn if kind == "attn" else ssm) + 2 * d
            if is_moe:
                m = self.moe
                total += (m.top_k if active_only else m.n_experts) * per_ff * m.d_ff_expert
                total += d * m.n_experts  # router
            else:
                total += per_ff * self.d_ff
        if self.is_encdec:
            total += self.n_encoder_layers * (attn + per_ff * self.d_ff + 2 * d)
            total += self.n_layers * (attn + d)
        return total

    def n_params(self):
        return self._count_params(active_only=False)

    def n_active_params(self):
        """Active parameters per token (MoE: only top_k experts count)."""
        return self._count_params(active_only=True)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


def shape_applicable(cfg, shape):
    """Whether (arch, shape) is a runnable dry-run cell, and why not (every
    architecture has a decode step, so that reason of the reference's never
    applies)."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, "pure full-attention arch: 500k decode KV is unbounded (see DESIGN.md)"
    return True, ""
