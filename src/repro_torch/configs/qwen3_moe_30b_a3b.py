"""qwen3-moe-30b-a3b — fine-grained MoE: 128 experts top-8.

[hf:Qwen/Qwen3-30B-A3B; hf]  48L d_model=2048 32H (GQA kv=4) d_ff=768 vocab=151936.
d_ff=768 is the PER-EXPERT ffn size (fine-grained experts).
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=768,
    vocab_size=151_936,
    head_dim=128,
    qk_norm=True,
    moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=768, every_n=1),
    rope_theta=1_000_000.0,
    scan_block=1,
    source="hf:Qwen/Qwen3-30B-A3B",
    notes="full attention -> long_500k skipped; EP shards 128 experts on model axis.",
)
