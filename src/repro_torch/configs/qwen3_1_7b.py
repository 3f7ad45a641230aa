"""qwen3-1.7b — dense GQA decoder with qk_norm.

[hf:Qwen/Qwen3-8B; hf]  28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=6144,
    vocab_size=151_936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    scan_block=1,
    source="hf:Qwen/Qwen3-8B",
    notes="qk_norm per-head RMSNorm on q/k; full attention -> long_500k skipped.",
)
