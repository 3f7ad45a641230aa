"""qwen2.5-14b — dense GQA decoder with QKV bias.

[hf:Qwen/Qwen2.5-0.5B; hf]  48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=13_824,
    vocab_size=152_064,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    scan_block=1,
    source="hf:Qwen/Qwen2.5-0.5B",
    notes="QKV linear bias; full attention -> long_500k skipped.",
)
