"""Mamba2 (SSD, state-space duality) mixer: the chunked prefill form and an
exact one-token recurrent decode form (the counterpart of
``src/repro/models/ssm.py``).

Within a chunk the output is an attention-like masked product; across
chunks a Python loop carries the (B, H, dh, N) fp32 state (the reference
scans). A sequence that is not a whole number of chunks is padded with
dt = 0, which neither writes nor decays the state. Decode carries
(conv window, ssm state) and costs O(1) a token.

Shapes: d_inner = expand · d_model, H = d_inner / d_head heads, N =
d_state, one group (B and C shared across heads).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..device import resolve_device
from .attention import _promote
from .layers import dense_init, rmsnorm, rmsnorm_init


def _dims(cfg):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = d_in // s.d_head
    conv_dim = d_in + 2 * s.d_state  # x, B, C all pass the causal conv
    return s, d_in, nh, conv_dim


def mamba2_init(generator: torch.Generator, cfg, dtype) -> dict:
    s, d_in, nh, conv_dim = _dims(cfg)
    d = cfg.d_model
    dev = generator.device
    return {  # in_proj emits [z | x | B | C | dt]
        "in_proj": dense_init(generator, (d, 2 * d_in + 2 * s.d_state + nh), dtype),
        "conv_w": (torch.randn((s.d_conv, conv_dim), generator=generator, device=dev)
                   * s.d_conv ** -0.5).to(dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "dt_bias": torch.zeros((nh,), dtype=dtype, device=dev),
        # A = -exp(a_log), log A uniform on [1, 16) as in mamba2
        "a_log": torch.log(torch.linspace(1.0, 16.0, nh, device=dev)).to(dtype),
        "d_skip": torch.ones((nh,), dtype=dtype, device=dev),
        "norm": rmsnorm_init(d_in, dtype, device=dev),
        "out_proj": dense_init(generator, (d_in, d), dtype),
    }


def _conv1d_causal(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B, T, C), w: (K, C):
    y[t] = Σ_i w[i] · x[t − (K−1) + i] + b, summed in i's order."""
    k, t = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    y = xp[:, 0:t] * w[0]
    for i in range(1, k):
        y = y + xp[:, i:i + t] * w[i]
    return y + b


def _split_proj(p, cfg, x: torch.Tensor):
    s, d_in, nh, conv_dim = _dims(cfg)
    zxbcdt = x @ p["in_proj"].to(x.dtype)
    return (zxbcdt[..., :d_in], zxbcdt[..., d_in:d_in + conv_dim],
            zxbcdt[..., d_in + conv_dim:])


def _post(p, cfg, y: torch.Tensor, z: torch.Tensor, x_dtype) -> torch.Tensor:
    """Gated RMSNorm and the out projection (mamba2's norm(y · silu(z)))."""
    y = rmsnorm(p["norm"], y * F.silu(z), cfg.norm_eps)
    return y @ p["out_proj"].to(x_dtype)


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Log-space segment sums: out[..., i, j] = Σ_{j < k ≤ i} x[..., k];
    −inf above the diagonal (the causal mask)."""
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    return torch.where(mask, seg, -math.inf)


def _chunk_step(h, xq, bq, cq, dtq, daq):
    """One chunk of the SSD: (state', y (B, Q, H, dh)), fp32 throughout."""
    xdt = xq * dtq[..., None]                              # (B, Q, H, dh)
    lmat = torch.exp(_segsum(daq.transpose(-1, -2)))       # (B, H, Q, Q)
    cb = torch.einsum("bqn,bsn->bqs", cq, bq)
    y_diag = torch.einsum("bhqs,bshd->bqhd", cb[:, None] * lmat, xdt)
    cum = torch.cumsum(daq, dim=1)                         # (B, Q, H)
    y_off = torch.einsum("bqn,bhdn->bqhd", cq, h) * torch.exp(cum)[..., None]
    decay_out = torch.exp(cum[:, -1:, :] - cum)            # step s → chunk end
    h = h * torch.exp(cum[:, -1, :])[..., None, None] + torch.einsum(
        "bsn,bshd->bhdn", bq, xdt * decay_out[..., None])
    return h, y_diag + y_off


def mamba2_forward(p, cfg, x: torch.Tensor, state: torch.Tensor | None = None):
    """x: (B, T, D). Returns (out (B, T, D), (conv window (B, d_conv − 1,
    conv_dim) in x's dtype, ssm state (B, H, dh, N) fp32)): the states
    hand the prefill off to decode."""
    s, d_in, nh, conv_dim = _dims(cfg)
    b, t, _ = x.shape
    q = min(s.chunk, t)
    tp = -(-t // q) * q
    dt_ = x.dtype

    z, xbc_pre, dt = _split_proj(p, cfg, x)
    conv_state = xbc_pre[:, -(s.d_conv - 1):, :]
    xbc = F.silu(_conv1d_causal(xbc_pre, p["conv_w"].to(dt_), p["conv_b"].to(dt_)))
    dt = F.softplus(dt.float() + p["dt_bias"].float())    # (B, T, H)
    if tp != t:  # state-neutral padding: dt → 0 kills both input and decay
        xbc = F.pad(xbc, (0, 0, 0, tp - t))
        dt = F.pad(dt, (0, 0, 0, tp - t))
    xs = xbc[..., :d_in].reshape(b, tp, nh, s.d_head)
    bmat = xbc[..., d_in:d_in + s.d_state].float()         # (B, T, N)
    cmat = xbc[..., d_in + s.d_state:].float()
    da = -torch.exp(p["a_log"].float()) * dt               # log decay ≤ 0
    xf = xs.float()

    h = (torch.zeros((b, nh, s.d_head, s.d_state), dtype=torch.float32, device=x.device)
         if state is None else state.float())
    ys = []
    for c0 in range(0, tp, q):
        c = slice(c0, c0 + q)
        h, yc = _chunk_step(h, xf[:, c], bmat[:, c], cmat[:, c], dt[:, c], da[:, c])
        ys.append(yc)
    y = torch.cat(ys, dim=1) + xf * p["d_skip"].float()[:, None]
    y = y.reshape(b, tp, d_in)[:, :t].to(dt_)
    return _post(p, cfg, y, z, dt_), (conv_state, h)


def mamba2_state_init(cfg, batch: int, dtype=torch.float32, device=None) -> tuple:
    """(conv window in ``dtype``, ssm state fp32), zeros on ``device``
    (None: the CUDA card)."""
    device = resolve_device(device)
    s, d_in, nh, conv_dim = _dims(cfg)
    return (torch.zeros((batch, s.d_conv - 1, conv_dim), dtype=dtype, device=device),
            torch.zeros((batch, nh, s.d_head, s.d_state), dtype=torch.float32, device=device))


def mamba2_decode(p, cfg, x: torch.Tensor, state: tuple):
    """x: (B, 1, D); state = (conv window, ssm state). Returns (out, state').
    The window takes the promoted dtype of the cached window and the new
    row, as the reference's ``concatenate`` does."""
    s, d_in, nh, conv_dim = _dims(cfg)
    conv_st, h = state
    b = x.shape[0]
    dt_ = x.dtype

    z, xbc, dt = _split_proj(p, cfg, x)                    # (B, 1, ·)
    window = torch.cat([conv_st, xbc], dim=1)              # (B, d_conv, conv_dim)
    conv_out = (torch.einsum("bkc,kc->bc", *_promote(window, p["conv_w"].to(dt_)))
                + p["conv_b"].to(dt_))
    xbc1 = F.silu(conv_out)
    xs = xbc1[:, :d_in].reshape(b, nh, s.d_head)
    bvec = xbc1[:, d_in:d_in + s.d_state].float()
    cvec = xbc1[:, d_in + s.d_state:].float()

    dt1 = F.softplus(dt[:, 0].float() + p["dt_bias"].float())  # (B, H)
    da = torch.exp(-torch.exp(p["a_log"].float()) * dt1)

    xdt = xs.float() * dt1[..., None]                      # (B, H, dh)
    h = h * da[..., None, None] + xdt[..., None] * bvec[:, None, None, :]
    y = torch.einsum("bhdn,bn->bhd", h, cvec)
    y = y + xs.float() * p["d_skip"].float()[:, None]
    out = _post(p, cfg, y.reshape(b, 1, d_in).to(dt_), z, dt_)
    return out, (window[:, 1:, :], h)


def mamba2_recurrent_ref(p, cfg, x: torch.Tensor):
    """Exact per-step recurrence, the oracle of the chunked form."""
    b = x.shape[0]
    state = mamba2_state_init(cfg, b, x.dtype, device=x.device)
    outs = []
    for i in range(x.shape[1]):
        o, state = mamba2_decode(p, cfg, x[:, i:i + 1], state)
        outs.append(o)
    return torch.cat(outs, dim=1), state
