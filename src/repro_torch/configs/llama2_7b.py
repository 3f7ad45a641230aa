"""llama2-7b — the paper's own evaluation model (StreamServe §4.1).

32L d_model=4096 32H (MHA kv=32) d_ff=11008 vocab=32000, float16 in the paper;
the port serves it in bfloat16.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama2-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11_008,
    vocab_size=32_000,
    head_dim=128,
    rope_theta=10_000.0,
    scan_block=1,
    source="paper §4.1 (Touvron et al. 2023)",
    notes="paper's serving model; used by the benchmark harness cost model.",
)
