"""qwen2-1.5b [dense] — GQA kv=2, QKV bias. [arXiv:2407.10671; hf]
28L d_model=1536 12H (d_head=128) d_ff=8960 vocab=151936, tied embeddings."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv=2,
    d_ff=8960,
    vocab=151936,
    d_head=128,
    qkv_bias=True,
    tie_embed=True,
    rope_theta=1_000_000.0,
)
