"""h2o-danube-3-4b — llama+mistral mix with sliding-window attention.

[arXiv:2401.16818; unverified]  24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000.
SWA window 4096 (mistral-style); swiglu MLP.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10_240,
    vocab_size=32_000,
    head_dim=120,
    sliding_window=4096,
    rope_theta=10_000.0,
    scan_block=1,
    source="arXiv:2401.16818",
    notes="SWA bounds decode KV by the window -> long_500k applies (rolling cache).",
)
