"""paligemma-3b [vlm] — SigLIP frontend STUB + Gemma backbone (MQA kv=1).
[arXiv:2407.07726; hf] 18L d_model=2048 8H (d_head=256) d_ff=16384
vocab=257216. ``input_specs`` supplies 256 precomputed patch embeddings
(width 1152); the prefix-LM mask attends fully within the image prefix."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv=1,
    d_ff=16384,
    vocab=257216,
    d_head=256,
    act="gelu_pytorch_tanh",
    tie_embed=True,
    vis_ctx=256,
    vis_width=1152,
    rope_theta=10_000.0,
)
