"""Blocked (flash) attention with a hand-written backward (the counterpart
of ``src/repro/models/flash.py``, its ``custom_vjp`` and its dense oracle).

The reference's docstring says that ``kernels/`` carries this dataflow as
a Pallas TPU kernel; no such kernel exists (every ``pallas_call`` of the
reference is a PC kernel), and the reference computes attention with
plain JAX ops. So does the port, in the same steps and the same order of
sums: the softmax runs online over key blocks, q grouped
(B, Tq, KV, G, dh) against k/v (B, Tk, KV, dh), k/v padded to whole
blocks with the pad keys masked, products in fp32 (bf16 operands under
``perf_flags.FLASH_BF16``), dv free to differ from dk.
``torch.nn.functional.scaled_dot_product_attention`` is not used: it sums
in another order. The backward is a ``torch.autograd.Function``, as the
reference's is a ``custom_vjp``: autograd through the forward loop would
keep every block's probabilities, the T² term the blocks exist to avoid.

Masks are specs, never materialized (B, T, T) tensors:
  ("causal", 0)      standard decoder mask
  ("prefix", p)      prefix-LM: full attention on [0, p)
  ("none", 0)        encoder / cross attention
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import perf_flags

NEG = -1e30


def _block_bias(q0: int, tq: int, k0: int, bk: int, kind: str, prefix: int,
                device) -> torch.Tensor:
    """(tq, bk) additive fp32 bias for query rows [q0, q0+tq) vs keys [k0, k0+bk)."""
    qpos = q0 + torch.arange(tq, device=device)[:, None]
    kpos = k0 + torch.arange(bk, device=device)[None, :]
    if kind == "causal":
        ok = kpos <= qpos
    elif kind == "prefix":
        ok = (kpos <= qpos) | (kpos < prefix)
    else:
        ok = torch.ones((tq, bk), dtype=torch.bool, device=device)
    return torch.where(ok, 0.0, NEG)


def _pad_tk(k: torch.Tensor, v: torch.Tensor, block_k: int):
    tk = k.shape[1]
    tkp = ((tk + block_k - 1) // block_k) * block_k
    if tkp != tk:
        k = F.pad(k, (0, 0, 0, 0, 0, tkp - tk))
        v = F.pad(v, (0, 0, 0, 0, 0, tkp - tk))
    return k, v, tk, tkp


def _mm_dtype() -> torch.dtype:
    return torch.bfloat16 if perf_flags.FLASH_BF16 else torch.float32


def _mm_operand(x: torch.Tensor, mmdt: torch.dtype) -> torch.Tensor:
    """x rounded to the product dtype and held in fp32: a product of two
    bf16 values is exact in fp32, so fp32 products of these operands are
    the reference's bf16 operands with fp32 accumulation."""
    return x.to(mmdt).float()


def _block_logits(qf, k, tq, tk, k0, block_k, scale, kind, prefix, mmdt):
    """(B, KV, G, Tq, block) fp32 logits of the key block at ``k0``, masked
    (the spec and the padded keys) by an additive bias, and the block's
    k in the product dtype."""
    dev = qf.device
    kb = _mm_operand(k[:, k0:k0 + block_k], mmdt)
    bias = _block_bias(0, tq, k0, block_k, kind, prefix, device=dev)
    kmask = (k0 + torch.arange(block_k, device=dev)) < tk  # un-padded keys
    bias = bias + torch.where(kmask, 0.0, NEG)[None, :]
    return torch.einsum("btkgd,bskd->bkgts", qf, kb) * scale + bias, kb


def _fwd_impl(q, k, v, scale, kind, prefix, block_k):
    """The online softmax over key blocks: (out (B, Tq, KV, G, dv) in q's
    dtype, the row log-sum-exp (B, KV, G, Tq) fp32; 0 where a row saw no
    key)."""
    b, tq, kv, g, _ = q.shape
    dhv = v.shape[-1]
    k, v, tk, tkp = _pad_tk(k, v, block_k)
    mmdt = _mm_dtype()
    qf = _mm_operand(q, mmdt)
    dev = q.device
    m = torch.full((b, kv, g, tq), float("-inf"), dtype=torch.float32, device=dev)
    l = torch.zeros((b, kv, g, tq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, kv, g, tq, dhv), dtype=torch.float32, device=dev)
    for k0 in range(0, tkp, block_k):
        logits, _ = _block_logits(qf, k, tq, tk, k0, block_k, scale, kind, prefix, mmdt)
        vb = _mm_operand(v[:, k0:k0 + block_k], mmdt)
        m_new = torch.maximum(m, logits.amax(-1))
        p = torch.exp(logits - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgts,bskd->bkgtd", _mm_operand(p, mmdt), vb)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    lse = torch.where(torch.isfinite(m), m + torch.log(l.clamp_min(1e-30)), 0.0)
    return out.movedim(-2, 1).to(q.dtype), lse


class _Flash(torch.autograd.Function):
    """The forward keeps (q, k, v, out, lse); the backward walks the same
    key blocks and recomputes each block's probabilities from the row
    log-sum-exp (``flash.py:111-148``), so no T² term is stored. dq sums
    over the blocks; each block's dk and dv are its own rows."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, kind: str, prefix: int, block_k: int):
        out, lse = _fwd_impl(q, k, v, scale, kind, prefix, block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.spec = (scale, kind, prefix, block_k)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        scale, kind, prefix, block_k = ctx.spec
        tq = q.shape[1]
        kpad, vpad, tk, tkp = _pad_tk(k, v, block_k)
        mmdt = _mm_dtype()
        qf = _mm_operand(q, mmdt)
        dof = _mm_operand(do, mmdt).movedim(1, -2)  # (B, KV, G, Tq, dv)
        dmat = (out.float().movedim(1, -2) * do.float().movedim(1, -2)).sum(-1)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dks, dvs = [], []
        for k0 in range(0, tkp, block_k):
            logits, kb = _block_logits(qf, kpad, tq, tk, k0, block_k, scale, kind, prefix,
                                       mmdt)
            vb = _mm_operand(vpad[:, k0:k0 + block_k], mmdt)
            p = torch.exp(logits - lse[..., None])  # the true probabilities
            dp = torch.einsum("bkgtd,bskd->bkgts", dof, vb)
            dsm = _mm_operand(p * (dp - dmat[..., None]), mmdt)
            dq = dq + torch.einsum("bkgts,bskd->btkgd", dsm, kb) * scale
            dks.append(torch.einsum("bkgts,btkgd->bskd", dsm, qf) * scale)
            dvs.append(torch.einsum("bkgts,bkgtd->bskd", _mm_operand(p, mmdt), dof))
        dk = torch.cat(dks, 1)[:, :tk]
        dv = torch.cat(dvs, 1)[:, :tk]
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                    kind: str = "causal", prefix: int = 0, block_k: int = 512
                    ) -> torch.Tensor:
    """q: (B, Tq, KV, G, dh); k: (B, Tk, KV, dh); v: (B, Tk, KV, dv)
    → (B, Tq, KV, G, dv) in q's dtype; differentiable in q, k and v."""
    return _Flash.apply(q, k, v, scale, kind, prefix, block_k)


def sdpa_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
             kind: str = "causal", prefix: int = 0) -> torch.Tensor:
    """Dense oracle for tests: identical math, materialized T² logits."""
    tq, tk = q.shape[1], k.shape[1]
    logits = torch.einsum("btkgd,bskd->bkgts", q.float(), k.float()) * scale \
        + _block_bias(0, tq, 0, tk, kind, prefix, device=q.device)
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgts,bskd->btkgd", w, v.float())
    return o.to(q.dtype)
