"""seamless-m4t-large-v2 — encoder-decoder, audio frontend STUB.

[arXiv:2308.11596; hf]  24L d_model=1024 16H (kv=16, i.e. MHA) d_ff=8192 vocab=256206.
24 encoder + 24 decoder layers; the speech frontend is a STUB per the
assignment: input_specs() provides precomputed frame embeddings.
"""
from repro_torch.configs.base import ArchConfig, FrontendConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,
    n_encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256_206,
    head_dim=64,
    mlp_type="gelu",
    frontend=FrontendConfig(kind="audio", n_tokens=1024),
    scan_block=1,
    source="arXiv:2308.11596",
    notes=(
        "enc-dec: shape seq_len = source frames for prefill (encoder), "
        "decode shapes run the decoder with self+cross KV; full attention -> "
        "long_500k skipped."
    ),
)
