"""rwkv6-3b [ssm] — Finch: attention-free, data-dependent per-channel decay.
[arXiv:2404.05892; hf] 32L d_model=2560 d_ff=8960 vocab=65536.
O(1) decode state → runs the long_500k cell."""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,                 # bookkeeping: 2560 / d_head(64)
    n_kv=40,
    d_ff=8960,
    vocab=65536,
    ssm=SSMConfig(kind="rwkv6", d_head=64, chunk=32),
    sub_quadratic=True,
)
