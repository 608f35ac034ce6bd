"""deepseek-v2-236b [moe] — MLA (kv_lora=512) + 2 shared + 160 routed top-6.
[arXiv:2405.04434; hf] 60L d_model=5120 128H d_expert=1536 vocab=102400.
Layer 0 is a dense 12288-wide FFN (the released model's first layer);
experts divide the 16-way model axis exactly (160 = 16 × 10)."""
from .base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv=128,
    d_ff=12288,              # dense layer-0 FFN width
    vocab=102400,
    moe=MoEConfig(n_routed=160, n_shared=2, top_k=6, d_expert=1536, n_padded=160,
                  norm_topk=False),
    mla=MLAConfig(q_lora=1536, kv_lora=512, d_nope=128, d_rope=64, d_v=128),
    n_dense_layers=1,
    rope_theta=10_000.0,
)
