"""qwen3-1.7b [dense] — qk_norm, GQA kv=8. [hf:Qwen/Qwen3 family]
28L d_model=2048 16H (d_head=128) d_ff=6144 vocab=151936."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv=8,
    d_ff=6144,
    vocab=151936,
    d_head=128,
    qk_norm=True,
    tie_embed=True,
    rope_theta=1_000_000.0,
)
