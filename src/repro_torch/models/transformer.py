"""LM assembly (the counterpart of ``src/repro/models/transformer.py``),
serving half, for the attention-MLP families.

A model is a *program*: an ordered list of homogeneous segments
(``program(cfg)``, every kind of the reference). The reference stacks a
segment's layers (L, ...) and scans them; the port holds one ``Block``
module a layer in ``LM.segments`` and loops, with the reference's
parameter names and einsum layouts (``wq`` (d, h, dh), ``wo`` (h, dh, d)),
so that ``state.lm_params_from_numpy`` only copies and unstacks. The
prefill's per-layer k/v and the decode cache keep the reference's stacked
(L, B, T, KV, dh) layout.

Segment kind ``attn_mlp`` (pre-norm GQA/MQA + gated or plain MLP: the
dense and vlm backbones) is ported; a program with any other kind raises
``NotImplementedError`` naming its ROADMAP item.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..device import resolve_device
from .attention import gqa_cache_init, gqa_decode, gqa_forward, gqa_init
from .layers import (dense_init, embed_init, layernorm, layernorm_init, mlp, mlp_init, rmsnorm,
                     rmsnorm_init, unembed)

#: segment kinds not yet ported → the ROADMAP item that brings them
UNPORTED = {
    "attn_moe": "14a-ii (MoE and MLA)", "mla_mlp": "14a-ii (MoE and MLA)",
    "mla_moe": "14a-ii (MoE and MLA)", "mamba": "14a-iii (SSM and hybrid)",
    "rwkv": "14a-iii (SSM and hybrid)", "site": "14a-iii (SSM and hybrid)",
}


@dataclass(frozen=True)
class SegSpec:
    kind: str
    count: int


def program(cfg) -> list[SegSpec]:
    if cfg.family == "hybrid":
        segs, every, left = [], cfg.shared_attn_every, cfg.n_layers
        while left > 0:
            k = min(every, left)
            segs.append(SegSpec("mamba", k))
            left -= k
            if left > 0 or k == every:
                segs.append(SegSpec("site", 1))
        return segs
    if cfg.ssm is not None and cfg.ssm.kind == "rwkv6":
        return [SegSpec("rwkv", cfg.n_layers)]
    if cfg.ssm is not None:
        return [SegSpec("mamba", cfg.n_layers)]
    if cfg.moe is not None and cfg.mla is not None:
        segs = []
        if cfg.n_dense_layers:
            segs.append(SegSpec("mla_mlp", cfg.n_dense_layers))
        segs.append(SegSpec("mla_moe", cfg.n_layers - cfg.n_dense_layers))
        return segs
    if cfg.moe is not None:
        return [SegSpec("attn_moe", cfg.n_layers)]
    return [SegSpec("attn_mlp", cfg.n_layers)]


def _require_ported(kind: str, name: str = "") -> None:
    if kind in UNPORTED:
        raise NotImplementedError(f"{name}segment kind {kind!r} is not ported yet: ROADMAP "
                                  f"item {UNPORTED[kind]}")
    if kind != "attn_mlp":
        raise ValueError(kind)


def check_ported(cfg) -> None:
    """Raise ``NotImplementedError`` when ``cfg``'s program holds a segment
    kind the port does not run yet (or the audio family)."""
    if cfg.family == "audio":
        raise NotImplementedError(
            f"{cfg.name}: the audio family (whisper.py, cross-attention) is not ported yet: "
            "ROADMAP item 14a-iv")
    for seg in program(cfg):
        _require_ported(seg.kind, f"{cfg.name}: ")


# ------------------------------------------------------------------ modules
class ParamTree(nn.Module):
    """A nested dict of tensors as a module, read as the reference reads
    its pytree: ``p["attn"]["wq"]``, ``"bq" in p``. Parameters carry no
    gradient (serving)."""

    def __init__(self, tree: dict):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, dict):
                self.add_module(key, ParamTree(val))
            else:
                self.register_parameter(key, nn.Parameter(val, requires_grad=False))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules


class Block(ParamTree):
    """One layer's parameters: the reference's block dict, unstacked."""


class LM(ParamTree):
    """The whole model: ``embed`` (V_pad, D), ``segments`` (one
    ``nn.ModuleList`` of ``Block``s a segment of ``program(cfg)``),
    ``final_norm``, and ``unembed`` (D, V_pad) and ``vis_proj`` where the
    config has them."""

    def __init__(self, cfg, tree: dict):
        check_ported(cfg)
        super().__init__({k: v for k, v in tree.items() if k != "segments"})
        self.segments = nn.ModuleList(nn.ModuleList(Block(layer) for layer in seg)
                                      for seg in tree["segments"])


# --------------------------------------------------------------- norm disp
def _norm_init(cfg, dtype, device):
    return (layernorm_init(cfg.d_model, dtype, device) if cfg.norm == "ln"
            else rmsnorm_init(cfg.d_model, dtype, device))


def _norm(cfg, p, x: torch.Tensor) -> torch.Tensor:
    return layernorm(p, x, cfg.norm_eps) if cfg.norm == "ln" else rmsnorm(p, x, cfg.norm_eps)


# -------------------------------------------------------------- block init
def block_init(generator: torch.Generator, cfg, dtype, kind: str) -> dict:
    _require_ported(kind)
    dev = generator.device
    return {"norm1": _norm_init(cfg, dtype, dev), "attn": gqa_init(generator, cfg, dtype),
            "norm2": _norm_init(cfg, dtype, dev),
            "ffn": mlp_init(generator, cfg.d_model, cfg.d_ff, dtype, gated=cfg.gated_mlp)}


def lm_init(generator: torch.Generator, cfg, dtype=torch.float32) -> LM:
    """Random parameters on the generator's device: the reference's shapes
    and scales, drawn from ``generator`` (the draws are not the reference's:
    ``jax.random`` is not reproduced)."""
    check_ported(cfg)
    tree = {
        "embed": embed_init(generator, cfg.padded_vocab, cfg.d_model, dtype),
        "segments": [[block_init(generator, cfg, dtype, seg.kind) for _ in range(seg.count)]
                     for seg in program(cfg)],
        "final_norm": _norm_init(cfg, dtype, generator.device),
    }
    if not cfg.tie_embed:
        tree["unembed"] = dense_init(generator, (cfg.d_model, cfg.padded_vocab), dtype,
                                     scale=0.02)
    if cfg.vis_ctx:
        tree["vis_proj"] = dense_init(generator, (cfg.vis_width, cfg.d_model), dtype)
    return LM(cfg, tree)


# ------------------------------------------------------------- block apply
def _ffn_part(p, cfg, x: torch.Tensor) -> torch.Tensor:
    return x + mlp(p["ffn"], _norm(cfg, p["norm2"], x), cfg.act)


def block_apply(p, cfg, kind: str, x: torch.Tensor, positions: torch.Tensor, mask):
    """Full-sequence form of one ``attn_mlp`` layer. Returns (x, (k, v))."""
    _require_ported(kind)
    attn_out, kv = gqa_forward(p["attn"], cfg, _norm(cfg, p["norm1"], x), positions, mask)
    return _ffn_part(p, cfg, x + attn_out), kv


def block_decode(p, cfg, kind: str, x: torch.Tensor, cache_l: dict, length: torch.Tensor):
    """One-token form; ``cache_l`` is this layer's {k, v} (no length).
    Returns (x, cache_l')."""
    _require_ported(kind)
    attn_out, new = gqa_decode(p["attn"], cfg, _norm(cfg, p["norm1"], x),
                               {**cache_l, "len": length})
    new.pop("len")
    return _ffn_part(p, cfg, x + attn_out), new


# ----------------------------------------------------------------- assembly
def _logits(p, cfg, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    x = _norm(cfg, p["final_norm"], x)
    if cfg.tie_embed:
        return unembed(x, p["embed"], compute_dtype)
    return (x @ p["unembed"].to(compute_dtype)).float()


def _embed_inputs(p, cfg, batch: dict, compute_dtype):
    """tokens (+ vis) → x (B, T, D), the mask spec, positions (B, T)."""
    tok = batch["tokens"]
    x = p["embed"][tok].to(compute_dtype)
    if cfg.vis_ctx:
        vis = batch["vis"].to(compute_dtype) @ p["vis_proj"].to(compute_dtype)
        x = torch.cat([vis, x], dim=1)
    b, t, _ = x.shape
    mask = ("prefix", cfg.vis_ctx) if cfg.vis_ctx else ("causal", 0)
    positions = torch.arange(t, dtype=torch.int32, device=x.device).expand(b, t)
    return x, mask, positions


@torch.inference_mode()
def lm_forward(p: LM, cfg, batch: dict, compute_dtype=torch.bfloat16, last_only: bool = False):
    """Prefill forward. Returns (logits fp32, per-segment (k, v) stacked
    (L, B, T, KV, dh)); ``last_only`` keeps the last position's logits
    (the serving prefill: no (B, T, V) fp32 tensor)."""
    x, mask, positions = _embed_inputs(p, cfg, batch, compute_dtype)
    caches = []
    for seg, seg_p in zip(program(cfg), p["segments"]):
        ks, vs = [], []
        for layer_p in seg_p:
            x, (k, v) = block_apply(layer_p, cfg, seg.kind, x, positions, mask)
            ks.append(k)
            vs.append(v)
        caches.append((torch.stack(ks), torch.stack(vs)))
    if last_only:
        x = x[:, -1:]
    return _logits(p, cfg, x, compute_dtype), caches


# -------------------------------------------------------------------- cache
def lm_cache_init(cfg, batch: int, t_max: int, dtype=torch.bfloat16, device=None
                  ) -> dict:
    """{segments: [{k, v: (L, B, T_max, KV, dh)}], len: () int32} on
    ``device`` (None: the CUDA card); t_max includes vis_ctx for vlm archs."""
    device = resolve_device(device)
    segs = []
    for seg in program(cfg):
        _require_ported(seg.kind)
        one = gqa_cache_init(cfg, batch, t_max, dtype, device)
        segs.append({name: one[name].repeat(seg.count, 1, 1, 1, 1) for name in ("k", "v")})
    return {"segments": segs, "len": torch.zeros((), dtype=torch.int32, device=device)}


@torch.inference_mode()
def lm_decode_step(p: LM, cfg, batch: dict, cache: dict, compute_dtype=torch.bfloat16):
    """One-token decode. batch: {"tokens": (B, 1)}. Writes the cache's
    tensors in place and returns (logits (B, 1, V_pad) fp32, cache')."""
    x = p["embed"][batch["tokens"]].to(compute_dtype)
    length = cache["len"]
    new_segs = []
    for seg, seg_p, seg_c in zip(program(cfg), p["segments"], cache["segments"]):
        for i, layer_p in enumerate(seg_p):
            x, _ = block_decode(layer_p, cfg, seg.kind, x,
                                {"k": seg_c["k"][i], "v": seg_c["v"][i]}, length)
        new_segs.append(seg_c)
    return _logits(p, cfg, x, compute_dtype), {"segments": new_segs, "len": length + 1}


@torch.inference_mode()
def lm_prefill(p: LM, cfg, batch: dict, t_max: int, compute_dtype=torch.bfloat16,
               cache_dtype=torch.bfloat16):
    """Prefill: the forward, then the per-layer k/v packed into a decode
    cache of ``t_max`` positions with ``len = T + vis_ctx``. Returns the
    last position's logits (B, 1, V_pad) and the cache."""
    logits, caches = lm_forward(p, cfg, batch, compute_dtype, last_only=True)
    b, t = batch["tokens"].shape
    t += cfg.vis_ctx or 0
    dev = logits.device
    cache = lm_cache_init(cfg, b, t_max, cache_dtype, device=dev)
    for (k, v), seg_c in zip(caches, cache["segments"]):
        seg_c["k"][:, :, :t] = k.to(cache_dtype)
        seg_c["v"][:, :, :t] = v.to(cache_dtype)
    cache["len"] = torch.full((), t, dtype=torch.int32, device=dev)
    return logits, cache
