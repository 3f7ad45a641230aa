"""mamba2-2.7b — SSD (state-space duality), attention-free.

[arXiv:2405.21060; unverified]  64L d_model=2560 d_ff=0 vocab=50280 ssm_state=128.
Mamba2 blocks only (no MLP: d_ff=0), RMSNorm, tied embeddings per the release.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50_280,
    head_dim=0,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, d_conv=4, chunk_size=256),
    tie_embeddings=True,
    scan_block=1,
    source="arXiv:2405.21060",
    notes="SSD dual form; decode keeps O(1) recurrent state -> long_500k applies.",
)
