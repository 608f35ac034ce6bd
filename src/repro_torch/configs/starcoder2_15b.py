"""starcoder2-15b [dense] — GQA kv=4, RoPE, LayerNorm + plain GELU MLP.
[arXiv:2402.19173; hf] 40L d_model=6144 48H d_ff=24576 vocab=49152."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv=4,
    d_ff=24576,
    vocab=49152,
    qkv_bias=True,
    norm="ln",
    gated_mlp=False,
    act="gelu_pytorch_tanh",
    rope_theta=100_000.0,
    norm_eps=1e-5,
)
