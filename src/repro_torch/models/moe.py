"""Mixture-of-Experts FFN: top-k routing with sort-based capacity dispatch,
shared experts and the load-balance aux loss (the counterpart of
``src/repro/models/moe.py``).

Routing softmaxes the fp32 router logits (dead padded experts masked to
−1e30), takes the top k in the reference's order and optionally
renormalises them. Dispatch sorts the N·k assignments stably by expert;
an assignment's slot is its rank within its expert, and slots at or past
the capacity ``cap`` (a Python int from static shapes) are dropped. The
kept tokens fill an (E, cap, D) buffer, two grouped products run the
experts, and the combine adds each token's k weighted rows.

On the card the reference's scatter-add combine (``moe.py:114``) would be
``index_put_(accumulate=True)``, whose atomics add a token's rows in a
different order from run to run. The port gathers each token's k rows
and adds them one at a time in the compute dtype, in the order of their
sorted position (ascending expert, the order of the reference's
scatter), so that two runs are bitwise equal on any device. Nothing here
reads a value back to the host: no boolean-mask indexing, no
``nonzero``, no ``.item()``.
"""
from __future__ import annotations

import torch

from .layers import act_fn, dense_init, mlp, mlp_init

NEG = -1e30


def moe_init(generator: torch.Generator, cfg, dtype) -> dict:
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_expert, m.padded
    p = {
        "router": dense_init(generator, (d, e), dtype, scale=0.02),
        "w_gate": dense_init(generator, (e, d, f), dtype),
        "w_up": dense_init(generator, (e, d, f), dtype),
        "w_down": dense_init(generator, (e, f, d), dtype),
    }
    if m.n_shared:
        p["shared"] = mlp_init(generator, d, f * m.n_shared, dtype, gated=True)
    return p


def capacity(cfg, n: int) -> int:
    """Slots an expert holds for ``n`` tokens (``moe.py:58``)."""
    m = cfg.moe
    return int(max(8, (n * m.top_k / max(m.n_routed, 1)) * m.capacity_factor))


def route(p, cfg, xf: torch.Tensor):
    """xf: (N, D) → (probs (N, E) fp32, gates (N, k) fp32, sel (N, k) int64)."""
    m = cfg.moe
    logits = (xf @ p["router"].to(xf.dtype)).float()
    if m.n_padded and m.n_padded > m.n_routed:
        dead = torch.arange(m.padded, device=xf.device) >= m.n_routed
        logits = torch.where(dead, NEG, logits)
    probs = torch.softmax(logits, dim=-1)
    gates, sel = torch.topk(probs, m.top_k, dim=-1, sorted=True)
    if m.norm_topk:
        gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    return probs, gates, sel


def slots(sel: torch.Tensor, n_experts: int, cap: int):
    """The sort-based slot plan of the (N, k) selections: ``order`` (the
    stable sort of the flat assignments by expert), the sorted experts, each
    sorted assignment's slot in its expert, whether it is kept
    (slot < cap), and its source token."""
    k = sel.shape[1]
    flat_e = sel.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    counts = torch.zeros(n_experts, dtype=torch.int64, device=sel.device)
    counts.scatter_add_(0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(flat_e.numel(), device=sel.device) - starts[e_sorted]
    return order, e_sorted, pos, pos < cap, order // k


def _combine(rows: torch.Tensor, order: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """rows: (N·k, D), one a sorted assignment, already weighted → (N, D):
    each token's k rows added in order of their sorted position, one add at
    a time in the rows' dtype (a fixed order: bitwise repeatable)."""
    at = torch.empty_like(order)
    at[order] = torch.arange(order.numel(), device=order.device)
    at = at.reshape(n, k).sort(dim=1).values  # a token's rows, ascending expert
    out = torch.zeros((n, rows.shape[1]), dtype=rows.dtype, device=rows.device)
    for j in range(k):
        out = out + rows[at[:, j]]
    return out


def moe_apply(p, cfg, x: torch.Tensor):
    """x: (B, T, D) → (out (B, T, D), aux loss () fp32)."""
    m = cfg.moe
    b, t, d = x.shape
    n, e, k = b * t, m.padded, m.top_k
    dt = x.dtype
    xf = x.reshape(n, d)
    probs, gates, sel = route(p, cfg, xf)

    # aux load-balance loss (Switch): E · Σ_e f_e · p_e
    me = probs.mean(dim=0)
    ce = torch.zeros(e, dtype=torch.float32, device=x.device)
    ce = ce.index_add(0, sel.reshape(-1), torch.ones(n * k, device=x.device)) / (n * k)
    aux = m.aux_loss_coef * e * (me * ce).sum()

    cap = capacity(cfg, n)
    order, e_sorted, pos, keep, tok = slots(sel, e, cap)
    slot_w = torch.where(keep, gates.reshape(-1)[order], 0.0)
    pos_c = torch.where(keep, pos, cap)  # a dropped assignment's write lands past cap
    buf = torch.zeros((e, cap + 1, d), dtype=dt, device=x.device)
    buf.index_put_((e_sorted, pos_c), xf[tok])
    buf = buf[:, :cap]

    # ---- grouped expert FFN
    h = torch.einsum("ecd,edf->ecf", buf, p["w_up"].to(dt))
    g = torch.einsum("ecd,edf->ecf", buf, p["w_gate"].to(dt))
    y = torch.einsum("ecf,efd->ecd", h * act_fn(cfg.act)(g), p["w_down"].to(dt))

    # ---- combine: a kept assignment's row times its gate (a dropped one's 0)
    rows = y[e_sorted, pos.clamp(max=cap - 1)] * slot_w[:, None].to(dt)
    out = _combine(rows, order, n, k)
    if m.n_shared:
        out = out + mlp(p["shared"], xf, cfg.act)
    return out.reshape(b, t, d), aux


def moe_ref(p, cfg, x: torch.Tensor) -> torch.Tensor:
    """Dense oracle: every expert on every token, combined by the gates.
    O(N·E): test scale only."""
    m = cfg.moe
    b, t, d = x.shape
    dt = x.dtype
    xf = x.reshape(-1, d)
    _, gates, sel = route(p, cfg, xf)
    h = torch.einsum("nd,edf->enf", xf, p["w_up"].to(dt))
    g = torch.einsum("nd,edf->enf", xf, p["w_gate"].to(dt))
    y = torch.einsum("enf,efd->end", h * act_fn(cfg.act)(g), p["w_down"].to(dt))
    full = torch.zeros((xf.shape[0], m.padded), dtype=torch.float32, device=x.device)
    full.scatter_(1, sel, gates)
    out = torch.einsum("end,ne->nd", y, full.to(dt))
    if m.n_shared:
        out = out + mlp(p["shared"], xf, cfg.act)
    return out.reshape(b, t, d)
