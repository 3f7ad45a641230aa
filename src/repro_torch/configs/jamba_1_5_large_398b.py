"""jamba-1.5-large-398b — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2.

[arXiv:2403.19887; hf]  72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536.
One attention layer per 8-layer block (attn_period=8); MoE every 2nd layer.
Optimizer: adafloor (factored second moment, ``training.optimizer``).
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24_576,
    vocab_size=65_536,
    head_dim=128,
    attn_period=8,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=24_576, every_n=2),
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, d_conv=4, chunk_size=256),
    optimizer="adafloor",
    remat_policy="full",
    scan_block=8,  # 8-layer blocks (7 mamba + 1 attn), as the reference stacks them
    source="arXiv:2403.19887",
    notes="hybrid: attention KV bounded to 9 layers -> long_500k applies.",
)
