"""Building blocks shared by every architecture, serving half (the
counterpart of ``src/repro/models/layers.py:15-103``).

Parameters are tensors of the param dtype, cast to the compute dtype of
the activations at each use; norms and RoPE compute in fp32 and cast
back, as the reference does.
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
