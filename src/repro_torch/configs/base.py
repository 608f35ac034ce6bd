"""Config dataclasses for the LM substrate and the assigned architectures
(a copy of ``src/repro/configs/base.py``: data only, no numpy)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    n_routed: int = 0               # routed experts (0 = dense FFN)
    n_shared: int = 0               # always-on shared experts
    top_k: int = 2
    d_expert: int = 0               # per-expert FFN width
    n_padded: int = 0               # routed experts padded for EP divisibility
    norm_topk: bool = True          # normalise top-k router weights
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.001

    @property
    def padded(self) -> int:
        return self.n_padded or self.n_routed


@dataclass(frozen=True)
class MLAConfig:
    q_lora: int = 1536
    kv_lora: int = 512
    d_nope: int = 128               # non-rotary per-head q/k dim
    d_rope: int = 64                # rotary shared key dim
    d_v: int = 128                  # per-head value dim


@dataclass(frozen=True)
class SSMConfig:
    kind: str = "mamba2"            # "mamba2" | "rwkv6"
    d_state: int = 64
    d_head: int = 64                # channels per SSM head
    d_conv: int = 4
    expand: int = 2                 # mamba inner = expand * d_model
    chunk: int = 64                 # chunked-scan block length


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense|moe|ssm|hybrid|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    d_head: int = 0                 # 0 → d_model // n_heads
    rope_theta: float = 10_000.0
    qk_norm: bool = False
    qkv_bias: bool = False
    tie_embed: bool = False
    act: str = "silu"               # silu | gelu | gelu_pytorch_tanh
    norm: str = "rms"               # rms | ln
    gated_mlp: bool = True          # SwiGLU-style vs plain 2-layer MLP
    norm_eps: float = 1e-6
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    n_dense_layers: int = 0         # leading dense layers before MoE stack
    # hybrid (zamba2): shared attention block applied every k-th backbone block
    shared_attn_every: int = 0
    shared_attn_lora: int = 0       # per-invocation LoRA rank on the shared block
    # enc-dec (whisper)
    n_enc_layers: int = 0
    enc_ctx: int = 0                # encoder context (stub frames / patches)
    # vlm (paligemma)
    vis_ctx: int = 0                # image patch tokens
    vis_width: int = 0              # stub patch-embedding width
    vocab_pad_to: int = 256         # pad vocab for TP divisibility
    sub_quadratic: bool = False     # supports long_500k decode

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_to
        return ((self.vocab + p - 1) // p) * p

    def reduced(self, **overrides) -> "ModelConfig":
        """Smoke-test scale version of the same family (CPU-runnable)."""
        small = dict(
            n_layers=min(self.n_layers, 2),
            d_model=128,
            n_heads=4,
            n_kv=min(max(self.n_kv * 4 // max(self.n_heads, 1), 1), 4),
            d_ff=256,
            vocab=512,
            d_head=32,
        )
        if self.moe:
            small["moe"] = dataclasses.replace(
                self.moe, n_routed=4, n_shared=min(self.moe.n_shared, 1),
                top_k=2, d_expert=64, n_padded=4,
            )
        if self.mla:
            small["mla"] = MLAConfig(q_lora=64, kv_lora=32, d_nope=32, d_rope=16, d_v=32)
        if self.ssm:
            small["ssm"] = dataclasses.replace(self.ssm, d_state=16, d_head=16, chunk=16)
        if self.n_enc_layers:
            small["n_enc_layers"] = 2
            small["enc_ctx"] = 32
        if self.vis_ctx:
            small["vis_ctx"] = 16
            small["vis_width"] = 64
        if self.n_dense_layers:
            small["n_dense_layers"] = 1
        if self.shared_attn_every:
            small["shared_attn_every"] = 2
            small["shared_attn_lora"] = min(self.shared_attn_lora, 16)
        small.update(overrides)
        return dataclasses.replace(self, **small)


@dataclass(frozen=True)
class ShapeCell:
    """One assigned (arch × input-shape) dry-run cell."""
    name: str                       # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


LM_SHAPES = (
    ShapeCell("train_4k", 4_096, 256, "train"),
    ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    ShapeCell("decode_32k", 32_768, 128, "decode"),
    ShapeCell("long_500k", 524_288, 1, "decode"),
)


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    grad_accum: int = 1
    remat: bool = True
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    zero1: bool = True              # shard optimizer state over (pod, data)
    grad_compress: bool = False     # int8 error-feedback cross-pod allreduce
    master_fp32: bool = False       # bf16 params + fp32 master in opt state
