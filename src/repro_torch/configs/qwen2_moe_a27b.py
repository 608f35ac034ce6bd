"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed top-4.
[hf:Qwen/Qwen1.5-MoE-A2.7B] 24L d_model=2048 16H kv=16 d_expert=1408
vocab=151936. 60 experts pad to 64 for the 16-way EP axis (router-masked
dead experts). Shared-expert width = 4 × 1408 = 5632 (matches HF)."""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv=16,
    d_ff=5632,
    vocab=151936,
    qkv_bias=True,
    moe=MoEConfig(n_routed=60, n_shared=4, top_k=4, d_expert=1408, n_padded=64,
                  norm_topk=False),
    rope_theta=1_000_000.0,
)
