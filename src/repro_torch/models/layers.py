"""Building blocks shared by every architecture (the counterpart of
``src/repro/models/layers.py``).

Parameters are tensors of the param dtype, cast to the compute dtype of
the activations at each use; norms and RoPE compute in fp32 and cast
back, as the reference does. The losses: ``cross_entropy`` over fp32
logits, and ``chunked_ce``, which streams the unembedding product over
vocabulary chunks in its forward and again in its backward, so that the
(N, V) fp32 logits never exist (the reference's ``custom_vjp``; here a
``torch.autograd.Function``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import resolve_device


def dense_init(generator: torch.Generator, shape, dtype, scale: float | None = None
               ) -> torch.Tensor:
    """Normal draws on the generator's device times ``scale`` (default
    fan_in ** -0.5, fan_in the leading dimension)."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else fan_in ** -0.5
    return (torch.randn(shape, generator=generator, device=generator.device) * scale).to(dtype)


def rmsnorm_init(d: int, dtype, device) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return (x * p["scale"].float()).to(dt)


def layernorm_init(d: int, dtype, device) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(dt)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    """The reference's table: its "gelu" is ``jax.nn.gelu``, whose default
    is the tanh approximation, so both gelus are the tanh form."""
    return {
        "silu": F.silu,
        "gelu": _gelu_tanh,
        "gelu_pytorch_tanh": _gelu_tanh,
        "relu": F.relu,
    }[name]


def mlp_init(generator: torch.Generator, d: int, f: int, dtype, gated: bool = True) -> dict:
    p = {"w_up": dense_init(generator, (d, f), dtype),
         "w_down": dense_init(generator, (f, d), dtype)}
    if gated:
        p["w_gate"] = dense_init(generator, (d, f), dtype)
    return p


def mlp(p, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    h = x @ p["w_up"].to(x.dtype)
    if "w_gate" in p:
        h = h * act_fn(act)(x @ p["w_gate"].to(x.dtype))
    else:
        h = act_fn(act)(h)
    return h @ p["w_down"].to(x.dtype)


def rope_freqs(d_rot: int, theta: float, device=None) -> torch.Tensor:
    """(d_rot/2,) fp32 inverse frequencies on ``device`` (None: the card)."""
    device = resolve_device(device)
    return 1.0 / (theta ** (torch.arange(0, d_rot, 2, dtype=torch.float32, device=device)
                            / d_rot))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10_000.0
               ) -> torch.Tensor:
    """x: (..., T, H, d) with d even; positions: (..., T) int. The
    half-split rotation in fp32, cast back to x's dtype."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)  # (d/2,)
    ang = positions[..., :, None].float() * freqs  # (..., T, d/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def embed_init(generator: torch.Generator, vocab: int, d: int, dtype) -> torch.Tensor:
    return (torch.randn((vocab, d), generator=generator, device=generator.device)
            * 0.02).to(dtype)


def unembed(x: torch.Tensor, table: torch.Tensor, compute_dtype) -> torch.Tensor:
    """Logits in fp32 over the table's (padded) vocabulary."""
    return (x.to(compute_dtype) @ table.to(compute_dtype).T).float()


def _ce_chunk(v_padded: int, want: int) -> int:
    """Largest divisor of v_padded ≤ want (vocab is padded to 256s)."""
    c = min(want, v_padded)
    while v_padded % c:
        c -= 1
    return max(c, 1)


def _chunk_logits(x: torch.Tensor, w: torch.Tensor, c0: int, chunk: int,
                  vocab_valid: int) -> torch.Tensor:
    """(N, chunk) fp32 logits of vocabulary ids [c0, c0 + chunk), padded ids
    at −inf."""
    logits = (x @ w[:, c0:c0 + chunk]).float()
    ids = c0 + torch.arange(chunk, device=x.device)
    return torch.where(ids < vocab_valid, logits, float("-inf"))


class _ChunkedCE(torch.autograd.Function):
    """Mean NLL over the valid rows, one vocabulary chunk at a time; the
    backward recomputes each chunk's logits from the saved row
    log-sum-exp (``layers.py:127-191``)."""

    @staticmethod
    def forward(ctx, x, w, labels, valid, vocab_valid: int, chunk: int):
        n = x.shape[0]
        dev = x.device
        m = torch.full((n,), float("-inf"), dtype=torch.float32, device=dev)
        l = torch.zeros((n,), dtype=torch.float32, device=dev)
        ll = torch.zeros((n,), dtype=torch.float32, device=dev)
        lab = labels.long()
        for c0 in range(0, w.shape[1], chunk):
            logits = _chunk_logits(x, w, c0, chunk, vocab_valid)
            m_new = torch.maximum(m, logits.amax(-1))
            l = l * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(-1)
            m = m_new
            inside = (lab >= c0) & (lab < c0 + chunk)
            local = (lab - c0).clamp(0, chunk - 1)
            ll = torch.where(inside, logits.gather(1, local[:, None])[:, 0], ll)
        lse = m + torch.log(l.clamp_min(1e-30))
        cnt = valid.sum().clamp_min(1)
        loss = torch.where(valid, lse - ll, 0.0).sum() / cnt
        ctx.save_for_backward(x, w, lab, valid, lse, cnt)
        ctx.vocab_valid, ctx.chunk = vocab_valid, chunk
        return loss

    @staticmethod
    def backward(ctx, g):
        x, w, lab, valid, lse, cnt = ctx.saved_tensors
        chunk = ctx.chunk
        scale = (g * valid.float() / cnt)[:, None]  # (N, 1)
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dws = []
        for c0 in range(0, w.shape[1], chunk):
            wc = w[:, c0:c0 + chunk]
            p = torch.exp(_chunk_logits(x, w, c0, chunk, ctx.vocab_valid) - lse[:, None])
            ids = c0 + torch.arange(chunk, device=x.device)
            onehot = (lab[:, None] == ids[None, :]).float()
            dlog = (p - onehot) * scale  # (N, chunk)
            dx = dx + (dlog.to(wc.dtype) @ wc.T).float()
            dws.append(x.T @ dlog.to(x.dtype))  # (D, chunk)
        return dx.to(x.dtype), torch.cat(dws, 1).to(w.dtype), None, None, None, None


def chunked_ce(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor,
               vocab_valid: int, chunk: int) -> torch.Tensor:
    """Streaming softmax CE. x: (N, D); w: (D, V); labels/valid: (N,).
    Returns the mean NLL over the valid rows; the chunk is the largest
    divisor of V at most ``chunk``."""
    return _ChunkedCE.apply(x, w, labels, valid, vocab_valid, _ce_chunk(w.shape[1], chunk))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor | None = None,
                  vocab_valid: int | None = None) -> torch.Tensor:
    """Token-mean CE; labels < 0 are ignored; padding vocab ids masked."""
    if vocab_valid is not None and vocab_valid < logits.shape[-1]:
        pad = torch.arange(logits.shape[-1], device=logits.device) >= vocab_valid
        logits = torch.where(pad, torch.finfo(logits.dtype).min, logits)
    valid = labels >= 0
    if mask is not None:
        valid = valid & (mask > 0)
    safe = labels.clamp_min(0).long()
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, safe[..., None])[..., 0]
    nll = (lse - ll) * valid
    return nll.sum() / valid.sum().clamp_min(1)
