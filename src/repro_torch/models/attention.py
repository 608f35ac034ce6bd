"""GQA/MQA attention (RoPE, qk-norm, bias) in a full-sequence form and a
one-token decode form against a KV cache, and the two dense masks (the
counterpart of ``src/repro/models/attention.py:21-106, 239-248``; MLA and
cross-attention arrive with their families, ROADMAP 14a-ii and 14a-iv).

KV cache layout: {k, v: (B, T_max, KV, dh), len: () int32 on the device}.
``gqa_decode`` writes position ``len`` in place and masks keys by
``arange(T_max) <= len``: a decode step reads no value back to the host
and keeps every shape fixed.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from .layers import apply_rope, dense_init, rmsnorm, rmsnorm_init

NEG = -1e30


def gqa_init(generator: torch.Generator, cfg, dtype) -> dict:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    dev = generator.device
    p = {
        "wq": dense_init(generator, (d, h, dh), dtype),
        "wk": dense_init(generator, (d, kv, dh), dtype),
        "wv": dense_init(generator, (d, kv, dh), dtype),
        "wo": dense_init(generator, (h, dh, d), dtype, scale=(h * dh) ** -0.5),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h, dh), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((kv, dh), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((kv, dh), dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(dh, dtype, device=dev)
        p["k_norm"] = rmsnorm_init(dh, dtype, device=dev)
    return p


def _qkv(p, cfg, x: torch.Tensor, positions: torch.Tensor):
    dt = x.dtype
    q = torch.einsum("btd,dhk->bthk", x, p["wq"].to(dt))
    k = torch.einsum("btd,dhk->bthk", x, p["wk"].to(dt))
    v = torch.einsum("btd,dhk->bthk", x, p["wv"].to(dt))
    if "bq" in p:
        q, k, v = q + p["bq"].to(dt), k + p["bk"].to(dt), v + p["bv"].to(dt)
    if "q_norm" in p:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _promote(a: torch.Tensor, b: torch.Tensor):
    """Both operands in their promoted dtype, as a JAX einsum of mixed
    dtypes computes."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor | None,
          scale: float) -> torch.Tensor:
    """q: (B, Tq, H, dh), k/v: (B, Tk, KV, dh) grouped; mask: (B, Tq, Tk) or
    None. The logits are formed in the promoted dtype of q and k and then
    upcast; the weights are cast to v's dtype before the second product."""
    b, tq, h, dh = q.shape
    kvh = k.shape[2]
    q = q.reshape(b, tq, kvh, h // kvh, dh)
    logits = torch.einsum("btkgd,bskd->bkgts", *_promote(q, k)).float() * scale
    if mask is not None:
        logits = torch.where(mask[:, None, None], logits, NEG)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    o = torch.einsum("bkgts,bskd->btkgd", w, v)
    return o.reshape(b, tq, h, v.shape[-1])


def gqa_forward(p, cfg, x: torch.Tensor, positions: torch.Tensor, mask):
    """Full-sequence attention (prefill). ``mask`` is a spec tuple
    ("causal" | "prefix" | "none", prefix_len); attention runs blocked
    (flash). Returns (out, (k, v))."""
    from .flash import flash_attention

    q, k, v = _qkv(p, cfg, x, positions)
    b, t, h, dh = q.shape
    kvh = k.shape[2]
    kind, prefix = mask if mask is not None else ("none", 0)
    qg = q.reshape(b, t, kvh, h // kvh, dh)
    o = flash_attention(qg, k, v, cfg.head_dim ** -0.5, kind, prefix)
    o = o.reshape(b, t, h, dh)
    return torch.einsum("bthk,hkd->btd", o, p["wo"].to(x.dtype)), (k, v)


def gqa_decode(p, cfg, x: torch.Tensor, cache: dict):
    """x: (B, 1, D); cache {k, v, len}. Writes this token's k/v at ``len``
    into the cache's tensors (in place) and returns (out, cache') with
    ``len + 1``. Past ``T_max`` the write lands on the last slot, as the
    reference's clamped ``dynamic_update_slice`` does."""
    length = cache["len"]
    pos = length.reshape(1, 1).expand(x.shape[0], 1)
    q, k1, v1 = _qkv(p, cfg, x, pos)
    k, v = cache["k"], cache["v"]
    t_max = k.shape[1]
    at = length.reshape(1).clamp(max=t_max - 1).long()
    k.index_copy_(1, at, k1.to(k.dtype))
    v.index_copy_(1, at, v1.to(v.dtype))
    mask = torch.arange(t_max, device=x.device)[None, None, :] <= length  # (1, 1, Tk)
    o = _sdpa(q, k, v, mask.expand(x.shape[0], 1, t_max), cfg.head_dim ** -0.5)
    out = torch.einsum("bthk,hkd->btd", *_promote(o, p["wo"].to(x.dtype)))
    return out, {"k": k, "v": v, "len": length + 1}


def gqa_cache_init(cfg, batch: int, t_max: int, dtype, device=None) -> dict:
    """An empty cache on ``device`` (None: the CUDA card)."""
    device = resolve_device(device)
    kv, dh = cfg.n_kv, cfg.head_dim
    return {
        "k": torch.zeros((batch, t_max, kv, dh), dtype=dtype, device=device),
        "v": torch.zeros((batch, t_max, kv, dh), dtype=dtype, device=device),
        "len": torch.zeros((), dtype=torch.int32, device=device),
    }


# ------------------------------------------------------------------- masks
def causal_mask(b: int, t: int, device=None) -> torch.Tensor:
    device = resolve_device(device)
    m = torch.tril(torch.ones((t, t), dtype=torch.bool, device=device))
    return m.expand(b, t, t)


def prefix_lm_mask(b: int, t: int, prefix_len: int, device=None) -> torch.Tensor:
    """Full attention within [0, prefix); causal after (PaliGemma-style)."""
    device = resolve_device(device)
    m = torch.tril(torch.ones((t, t), dtype=torch.bool, device=device))
    m = m | (torch.arange(t, device=device)[None, :] < prefix_len)
    return m.expand(b, t, t)
