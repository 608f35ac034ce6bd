"""whisper-large-v3 [audio] — enc-dec; conv/mel frontend is a STUB
(``input_specs`` supplies 1500 precomputed frame embeddings).
[arXiv:2212.04356; unverified tier] 32L enc + 32L dec, d_model=1280 20H
d_ff=5120 vocab=51866 (padded to 51968 for 16-way TP)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,                # decoder layers
    n_enc_layers=32,
    enc_ctx=1500,
    d_model=1280,
    n_heads=20,
    n_kv=20,
    d_ff=5120,
    vocab=51866,
    norm="ln",
    gated_mlp=False,
    act="gelu",
    norm_eps=1e-5,
)
