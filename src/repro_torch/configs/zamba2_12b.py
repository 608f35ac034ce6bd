"""zamba2-1.2b [hybrid] — Mamba2 backbone + ONE shared attention block
invoked every 6 backbone layers with per-site LoRA deltas.
[arXiv:2411.15242; hf] 38L d_model=2048 32H d_ff=8192 vocab=32000
ssm_state=64. Hybrid → O(1) backbone state; only the 6 shared-attn call
sites keep KV caches, so long_500k runs."""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv=32,
    d_ff=8192,
    vocab=32000,
    ssm=SSMConfig(kind="mamba2", d_state=64, d_head=64, d_conv=4, expand=2, chunk=64),
    shared_attn_every=6,
    shared_attn_lora=128,
    sub_quadratic=True,
)
