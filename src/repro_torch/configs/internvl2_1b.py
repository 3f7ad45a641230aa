"""internvl2-1b — VLM: InternViT frontend STUB + Qwen2-0.5B-class backbone.

[arXiv:2404.16821; hf]  24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655.
The vision frontend is a STUB per the assignment: input_specs() provides
precomputed patch embeddings of shape (batch, n_patches, d_model).
"""
from repro_torch.configs.base import ArchConfig, FrontendConfig

CONFIG = ArchConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151_655,
    head_dim=64,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    frontend=FrontendConfig(kind="vision", n_tokens=256),
    tie_embeddings=True,
    scan_block=1,
    source="arXiv:2404.16821",
    notes="backbone only; vision patches precomputed; full attention -> long_500k skipped.",
)
