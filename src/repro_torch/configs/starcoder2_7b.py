"""starcoder2-7b — dense GQA decoder, RoPE, GELU MLP.

[arXiv:2402.19173; hf]  32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152.
StarCoder2 uses a standard (non-gated) GELU MLP with d_ff = 4*d_model.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18_432,
    vocab_size=49_152,
    head_dim=128,
    mlp_type="gelu",
    rope_theta=100_000.0,
    scan_block=1,
    source="arXiv:2402.19173",
    notes="full attention (4k sliding variant not assigned) -> long_500k skipped.",
)
