"""RWKV6 ("Finch") mixer: linear attention with a data-dependent
per-channel decay, and the channel mix (the counterpart of
``src/repro/models/rwkv6.py``). Attention-free: the decode state is O(1).

  * ``rwkv6_mix_chunked``: prefill, chunk-parallel. A Python loop over
    chunks carries the state; the intra-chunk term is a masked (Q, Q)
    product in log-decay space (every exponent ≤ 0).
  * ``rwkv6_mix_recurrent``: the exact per-token recurrence (decode, and
    the chunked form's oracle).

Per head with dh-wide keys, state S (dh × dh):
  o_t = r_t · (S_{t−1} + (u ⊙ k_t) v_tᵀ)
  S_t = diag(w_t) S_{t−1} + k_t v_tᵀ,  w_t = exp(−exp(wlog_t)) ∈ (0, 1).

The decay path is fp32 under any compute dtype, and the wkv state and
both token-shift carries are fp32 and stay so in the cache.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import resolve_device
from .layers import dense_init

DDLORA = 32  # data-dependent lerp lora rank (5 mixes)
WLORA = 64   # decay lora rank


def _dims(cfg):
    d = cfg.d_model
    dh = cfg.ssm.d_head
    return d, dh, d // dh


def rwkv6_mix_init(generator: torch.Generator, cfg, dtype) -> dict:
    d, dh, nh = _dims(cfg)
    dev = generator.device
    lin = torch.linspace(0, 1, d, dtype=torch.float32, device=dev)

    def full(shape, v):
        return torch.full(shape, v, dtype=dtype, device=dev)

    return {
        "mu_x": full((d,), 0.5),                          # base token-shift lerp
        "mu5": full((5, d), 0.5),                         # per-projection base
        "tm_w1": dense_init(generator, (d, 5 * DDLORA), dtype, scale=1e-2),
        "tm_w2": dense_init(generator, (5, DDLORA, d), dtype, scale=1e-2),
        "w0": (-6.0 + 5.0 * lin).to(dtype),               # per-channel decay bias
        "w1": dense_init(generator, (d, WLORA), dtype, scale=1e-2),
        "w2": dense_init(generator, (WLORA, d), dtype, scale=1e-2),
        "u": full((nh, dh), 0.5),                         # the current token's bonus
        "wr": dense_init(generator, (d, d), dtype),
        "wk": dense_init(generator, (d, d), dtype),
        "wv": dense_init(generator, (d, d), dtype),
        "wg": dense_init(generator, (d, d), dtype),
        "wo": dense_init(generator, (d, d), dtype),
        "ln_x_scale": full((d,), 1.0),                    # per-head groupnorm
        "ln_x_bias": full((d,), 0.0),
    }


def _ddlerp(p, x: torch.Tensor, xprev: torch.Tensor) -> torch.Tensor:
    """The data-dependent lerp: the 5 mixed inputs (r, k, v, w, g),
    stacked (5, B, T, D)."""
    dt = x.dtype
    dx = xprev - x
    xxx = x + dx * p["mu_x"].to(dt)
    hid = torch.tanh(xxx @ p["tm_w1"].to(dt))             # (B, T, 5·R)
    b, t, _ = x.shape
    dyn = torch.einsum("btfr,frd->fbtd", hid.reshape(b, t, 5, DDLORA), p["tm_w2"].to(dt))
    return x[None] + dx[None] * (p["mu5"].to(dt)[:, None, None, :] + dyn)


def _rkvwg(p, cfg, x: torch.Tensor, xprev: torch.Tensor):
    d, dh, nh = _dims(cfg)
    dt = x.dtype
    mr, mk, mv, mw, mg = _ddlerp(p, x, xprev)
    r = mr @ p["wr"].to(dt)
    k = mk @ p["wk"].to(dt)
    v = mv @ p["wv"].to(dt)
    g = F.silu(mg @ p["wg"].to(dt))
    wlog = p["w0"].float() + torch.tanh(mw.float() @ p["w1"].float()) @ p["w2"].float()
    logw = -torch.exp(wlog)                               # log decay ≤ 0, fp32
    b, t, _ = x.shape
    return tuple(z.reshape(b, t, nh, dh) for z in (r, k, v, logw)) + (g,)


def _groupnorm_heads(p, x: torch.Tensor, nh: int, eps: float = 64e-5) -> torch.Tensor:
    """LayerNorm per head (RWKV's ln_x, GroupNorm(nh)), in fp32."""
    b, t, d = x.shape
    xh = x.reshape(b, t, nh, d // nh).float()
    mu = xh.mean(-1, keepdim=True)
    var = ((xh - mu) ** 2).mean(-1, keepdim=True)
    xh = (xh - mu) * torch.rsqrt(var + eps)
    return xh.reshape(b, t, d) * p["ln_x_scale"].float() + p["ln_x_bias"].float()


def _shift(x: torch.Tensor, xlast: torch.Tensor | None = None) -> torch.Tensor:
    """Token shift; ``xlast`` (B, D) is the previous segment's carry, cast to
    x's dtype (an fp32 carry does not promote)."""
    first = torch.zeros_like(x[:, :1]) if xlast is None else xlast[:, None, :].to(x.dtype)
    return torch.cat([first, x[:, :-1]], dim=1)


def _out(p, y: torch.Tensor, g: torch.Tensor, nh: int, dt_) -> torch.Tensor:
    out = _groupnorm_heads(p, y, nh) * g.float()
    return out.to(dt_) @ p["wo"].to(dt_)


def _chunk_step(s, u, rq, kq, vq, lwq):
    """One chunk, fp32: (state', y (B, Q, H, dh))."""
    q = rq.shape[1]
    cum = torch.cumsum(lwq, dim=1)                        # inclusive
    cum_prev = cum - lwq                                  # exclusive
    # A_ts = Σ_d r_td k_sd exp(cum_{t−1,d} − cum_{s,d}) for s < t
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=rq.device), -1)
    pair = torch.where(mask[None, :, :, None, None],
                       torch.exp(cum_prev[:, :, None] - cum[:, None]), 0.0)  # (B, t, s, H, dh)
    amat = (rq[:, :, None] * kq[:, None] * pair).sum(-1)  # (B, t, s, H)
    y_intra = torch.einsum("btsh,bshe->bthe", amat, vq)
    y_bonus = (rq * u[None, None] * kq).sum(-1, keepdim=True) * vq
    y_inter = torch.einsum("bthd,bhde->bthe", rq * torch.exp(cum_prev), s)
    k_dec = kq * torch.exp(cum[:, -1:] - cum)
    s = s * torch.exp(cum[:, -1])[..., None] + torch.einsum("bshd,bshe->bhde", k_dec, vq)
    return s, y_intra + y_bonus + y_inter


def rwkv6_mix_chunked(p, cfg, x: torch.Tensor, state: torch.Tensor | None = None,
                      xlast: torch.Tensor | None = None):
    """x: (B, T, D). Returns (out, (S (B, H, dh, dh) fp32, x_last (B, D)
    fp32)). T need not be a whole number of chunks: the pad has k, v = 0
    (no state write) and log w = 0 (no decay)."""
    d, dh, nh = _dims(cfg)
    b, t, _ = x.shape
    q = min(cfg.ssm.chunk, t)
    tp = -(-t // q) * q
    dt_ = x.dtype

    r, k, v, logw, g = _rkvwg(p, cfg, x, _shift(x, xlast))
    u = p["u"].float()
    r, k, v, logw = (F.pad(z.float(), (0, 0, 0, 0, 0, tp - t)) for z in (r, k, v, logw))

    s = (torch.zeros((b, nh, dh, dh), dtype=torch.float32, device=x.device)
         if state is None else state.float())
    ys = []
    for c0 in range(0, tp, q):
        c = slice(c0, c0 + q)
        s, yc = _chunk_step(s, u, r[:, c], k[:, c], v[:, c], logw[:, c])
        ys.append(yc)
    y = torch.cat(ys, dim=1)[:, :t]
    return _out(p, y.reshape(b, t, d), g, nh, dt_), (s, x[:, -1, :].float())


def rwkv6_mix_recurrent(p, cfg, x: torch.Tensor, state: torch.Tensor | None = None,
                        xlast: torch.Tensor | None = None):
    """The exact per-token recurrence: the decode path and the chunked
    form's oracle. Returns what ``rwkv6_mix_chunked`` returns."""
    d, dh, nh = _dims(cfg)
    b, t, _ = x.shape
    r, k, v, logw, g = _rkvwg(p, cfg, x, _shift(x, xlast))
    r, k, v, logw = r.float(), k.float(), v.float(), logw.float()
    u = p["u"].float()
    s = (torch.zeros((b, nh, dh, dh), dtype=torch.float32, device=x.device)
         if state is None else state.float())
    outs = []
    for i in range(t):
        kv = k[:, i, :, :, None] * v[:, i, :, None, :]    # (B, H, dh, dh)
        outs.append(torch.einsum("bhd,bhde->bhe", r[:, i], s + u[None, :, :, None] * kv))
        s = s * torch.exp(logw[:, i])[..., None] + kv
    y = torch.stack(outs, dim=1).reshape(b, t, d)
    return _out(p, y, g, nh, x.dtype), (s, x[:, -1, :].float())


def rwkv6_state_init(cfg, batch: int, device=None) -> tuple:
    """(wkv state, time-mix carry, channel-mix carry), fp32 zeros on
    ``device`` (None: the CUDA card)."""
    device = resolve_device(device)
    d, dh, nh = _dims(cfg)
    return tuple(torch.zeros(shape, dtype=torch.float32, device=device)
                 for shape in ((batch, nh, dh, dh), (batch, d), (batch, d)))


# --------------------------------------------------------------- channel mix
def rwkv6_cmix_init(generator: torch.Generator, cfg, dtype) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    dev = generator.device
    return {
        "mu_k": torch.full((d,), 0.5, dtype=dtype, device=dev),
        "mu_r": torch.full((d,), 0.5, dtype=dtype, device=dev),
        "wk": dense_init(generator, (d, f), dtype),
        "wv": dense_init(generator, (f, d), dtype),
        "wr": dense_init(generator, (d, d), dtype),
    }


def rwkv6_cmix(p, cfg, x: torch.Tensor, xlast: torch.Tensor | None = None):
    """Returns (out, x_last (B, D) fp32)."""
    dt = x.dtype
    dx = _shift(x, xlast) - x
    xk = x + dx * p["mu_k"].to(dt)
    xr = x + dx * p["mu_r"].to(dt)
    k = torch.square(F.relu(xk @ p["wk"].to(dt)))
    out = torch.sigmoid(xr @ p["wr"].to(dt)) * (k @ p["wv"].to(dt))
    return out, x[:, -1, :].float()
