"""stablelm-3b [dense] — MHA (kv=32), LayerNorm, gated SiLU MLP.
[hf:stabilityai/stablelm family; unverified tier]
32L d_model=2560 32H d_ff=6912 vocab=50304."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv=32,
    d_ff=6912,
    vocab=50304,
    norm="ln",
    rope_theta=10_000.0,
    norm_eps=1e-5,
)
