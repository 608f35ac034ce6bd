"""Attention mixers: GQA/MQA (RoPE, qk-norm, bias) and MLA (DeepSeek-V2),
each in a full-sequence form and a one-token decode form against a cache,
Whisper's cross-attention, and the two dense masks (the counterpart of
``src/repro/models/attention.py``).

GQA cache: {k, v: (B, T_max, KV, dh), len: () int32 on the device}. MLA
cache, compressed (the point of MLA): {ckv: (B, T_max, kv_lora), kpe:
(B, T_max, d_rope), len}. Decode writes position ``len`` in place and
masks keys by ``arange(T_max) <= len``: a decode step reads no value back
to the host and keeps every shape fixed.
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


# ======================================================================= MLA
def mla_init(generator: torch.Generator, cfg, dtype) -> dict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    dev = generator.device
    return {
        "wq_a": dense_init(generator, (d, m.q_lora), dtype),
        "q_a_norm": rmsnorm_init(m.q_lora, dtype, device=dev),
        "wq_b": dense_init(generator, (m.q_lora, h, m.d_nope + m.d_rope), dtype),
        "wkv_a": dense_init(generator, (d, m.kv_lora + m.d_rope), dtype),
        "kv_a_norm": rmsnorm_init(m.kv_lora, dtype, device=dev),
        "wk_b": dense_init(generator, (m.kv_lora, h, m.d_nope), dtype),
        "wv_b": dense_init(generator, (m.kv_lora, h, m.d_v), dtype),
        "wo": dense_init(generator, (h, m.d_v, d), dtype, scale=(h * m.d_v) ** -0.5),
    }


def _mla_q(p, cfg, x: torch.Tensor, positions: torch.Tensor):
    m = cfg.mla
    dt = x.dtype
    qa = rmsnorm(p["q_a_norm"], x @ p["wq_a"].to(dt), cfg.norm_eps)
    q = torch.einsum("btl,lhk->bthk", qa, p["wq_b"].to(dt))
    q_nope, q_pe = q[..., :m.d_nope], q[..., m.d_nope:]
    return q_nope, apply_rope(q_pe, positions, cfg.rope_theta)


def _mla_ckv(p, cfg, x: torch.Tensor, positions: torch.Tensor):
    """The compressed cache entries: (ckv (B, T, kv_lora), kpe (B, T, d_rope))."""
    m = cfg.mla
    kv = x @ p["wkv_a"].to(x.dtype)
    ckv = rmsnorm(p["kv_a_norm"], kv[..., :m.kv_lora], cfg.norm_eps)
    kpe = apply_rope(kv[..., None, m.kv_lora:], positions, cfg.rope_theta)[..., 0, :]
    return ckv, kpe


def mla_forward(p, cfg, x: torch.Tensor, positions: torch.Tensor, mask):
    """Prefill: k/v expanded per head; the two-term score q_nope·k_nope +
    q_pe·k_pe folded into one blocked attention by concatenating the rotary
    part onto the head dim (k_pe broadcast across heads): dk = d_nope +
    d_rope, dv = d_v. Returns (out, (ckv, kpe)), the compressed cache."""
    from .flash import flash_attention

    m = cfg.mla
    dt = x.dtype
    q_nope, q_pe = _mla_q(p, cfg, x, positions)
    ckv, kpe = _mla_ckv(p, cfg, x, positions)
    k_nope = torch.einsum("bsl,lhk->bshk", ckv, p["wk_b"].to(dt))
    v = torch.einsum("bsl,lhk->bshk", ckv, p["wv_b"].to(dt))
    b, t, h, _ = q_nope.shape
    s = ckv.shape[1]
    qcat = torch.cat([q_nope, q_pe], -1)[:, :, :, None, :]  # KV = H, G = 1
    kcat = torch.cat([k_nope, kpe[:, :, None, :].expand(b, s, h, m.d_rope)], -1)
    kind, prefix = mask if mask is not None else ("none", 0)
    o = flash_attention(qcat, kcat, v, (m.d_nope + m.d_rope) ** -0.5, kind, prefix)[:, :, :, 0]
    return torch.einsum("bthk,hkd->btd", o, p["wo"].to(dt)), (ckv, kpe)


def mla_decode(p, cfg, x: torch.Tensor, cache: dict):
    """Absorbed decode: W_uk folds into the query and W_uv into the
    context, so scores and context live in the kv_lora-wide compressed
    space and the cache stays compressed. Writes this token's ckv/kpe at
    ``len`` in place. The softmax weights are cast to the compute dtype
    (``attention.py:193``; GQA casts them to the cache's)."""
    m = cfg.mla
    dt = x.dtype
    length = cache["len"]
    pos = length.reshape(1, 1).expand(x.shape[0], 1)
    q_nope, q_pe = _mla_q(p, cfg, x, pos)  # (B, 1, H, ·)
    ckv1, kpe1 = _mla_ckv(p, cfg, x, pos)
    ckv, kpe = cache["ckv"], cache["kpe"]
    t_max = ckv.shape[1]
    at = length.reshape(1).clamp(max=t_max - 1).long()
    ckv.index_copy_(1, at, ckv1.to(ckv.dtype))
    kpe.index_copy_(1, at, kpe1.to(kpe.dtype))
    q_eff = torch.einsum("bthk,lhk->bthl", q_nope, p["wk_b"].to(dt))
    logits = (torch.einsum("bthl,bsl->bhts", *_promote(q_eff, ckv))
              + torch.einsum("bthk,bsk->bhts", *_promote(q_pe, kpe))).float()
    logits = logits * (m.d_nope + m.d_rope) ** -0.5
    mask = torch.arange(t_max, device=x.device)[None, None, None, :] <= length
    w = torch.softmax(torch.where(mask, logits, NEG), dim=-1).to(dt)
    ctx = torch.einsum("bhts,bsl->bthl", *_promote(w, ckv))  # compressed context
    o = torch.einsum("bthl,lhk->bthk", *_promote(ctx, p["wv_b"].to(dt)))
    out = torch.einsum("bthk,hkd->btd", *_promote(o, p["wo"].to(dt)))
    return out, {"ckv": ckv, "kpe": kpe, "len": length + 1}


def mla_cache_init(cfg, batch: int, t_max: int, dtype, device=None) -> dict:
    """An empty compressed cache on ``device`` (None: the CUDA card)."""
    device = resolve_device(device)
    m = cfg.mla
    return {
        "ckv": torch.zeros((batch, t_max, m.kv_lora), dtype=dtype, device=device),
        "kpe": torch.zeros((batch, t_max, m.d_rope), dtype=dtype, device=device),
        "len": torch.zeros((), dtype=torch.int32, device=device),
    }


# =========================================================== cross-attention
def cross_init(generator: torch.Generator, cfg, dtype) -> dict:
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    return {
        "wq": dense_init(generator, (d, h, dh), dtype),
        "wk": dense_init(generator, (d, h, dh), dtype),
        "wv": dense_init(generator, (d, h, dh), dtype),
        "wo": dense_init(generator, (h, dh, d), dtype, scale=(h * dh) ** -0.5),
    }


def cross_kv(p, enc_out: torch.Tensor):
    """The encoder output's keys and values: (B, S, H, dh) each."""
    dt = enc_out.dtype
    k = torch.einsum("bsd,dhk->bshk", enc_out, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", enc_out, p["wv"].to(dt))
    return k, v


def cross_forward(p, cfg, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """x: (B, T, D) queries against the encoder's k/v (B, S, H, dh): blocked
    attention with no mask, one query head a key head (G = 1)."""
    from .flash import flash_attention

    dt = x.dtype
    q = torch.einsum("btd,dhk->bthk", x, p["wq"].to(dt))
    o = flash_attention(q[:, :, :, None, :], k, v, cfg.head_dim ** -0.5, "none", 0)
    return torch.einsum("bthk,hkd->btd", o[:, :, :, 0, :], p["wo"].to(dt))


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
