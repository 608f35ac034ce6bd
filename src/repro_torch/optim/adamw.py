"""AdamW from first principles (the counterpart of
``src/repro/optim/adamw.py``), over the port's trees (``repro_torch.tree``).

The state mirrors the parameter tree as plain containers: ``m`` and ``v``
in fp32 whatever the parameter dtype, ``step`` a () int32 device tensor,
and ``master``, fp32 copies of the parameters, under ``master_fp32``. The
update runs on the device and reads nothing back to the host; it writes
the parameters, ``m``, ``v`` and ``master`` in place and returns them.

Weight decay follows the reference's rule, ``ndim >= 2`` of its leaf
(``adamw.py:71``). The reference stacks a segment's layers, so a norm
scale inside a stack, (L, D) there, is decayed; the port's per-layer
``Block`` holds it as (D,), and the rule reads its stacked rank
(``tree.stacked_ndim``). The global norm adds the leaves' squared sums in
the reference's flatten order, a stack's layers summed into their
stacked leaf first.
"""
from __future__ import annotations

import math

import torch

from .. import tree as T


def warmup_cosine(step, base_lr: float, warmup: int, total: int, floor: float = 0.1):
    """Linear warmup → cosine decay to floor·base_lr (fp32, on ``step``'s
    device)."""
    step = torch.as_tensor(step).float()
    warm = base_lr * (step + 1) / max(warmup, 1)  # never a 0-LR step
    prog = ((step - warmup) / max(total - warmup, 1)).clamp(0.0, 1.0)
    cos = floor * base_lr + (1 - floor) * base_lr * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < warmup, warm, cos)


def _flat(tree) -> list:
    return tree if isinstance(tree, list) and not isinstance(tree, T.Layers) else T.leaves(tree)


def clip_by_global_norm(grads, max_norm: float, like=None):
    """(grads scaled to a global norm of at most ``max_norm``, the norm
    before). ``grads``: a tree, or its leaves as a list in the flatten
    order of ``like`` (the parameters), whose stacks group the sum."""
    flat = _flat(grads)
    groups = T.stacked_groups(like if like is not None else grads)
    sq = [g.float().square().sum() for g in flat]
    total = None
    for group in groups:
        part = sq[group[0]]
        for i in group[1:]:
            part = part + sq[i]
        total = part if total is None else total + part
    gn = torch.sqrt(total)
    scale = torch.clamp(max_norm / gn.clamp_min(1e-9), max=1.0)
    out = [(g.float() * scale).to(g.dtype) for g in flat]
    return (out if flat is grads else T.unflatten_like(grads, out)), gn


def adamw_init(params, master_fp32: bool = False) -> dict:
    leaf = T.leaves(params)[0]
    state = {
        "m": T.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                        params),
        "v": T.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                        params),
        "step": torch.zeros((), dtype=torch.int32, device=leaf.device),
    }
    if master_fp32:
        # low-precision parameters on the wire, the fp32 truth here
        state["master"] = T.tree_map(lambda p: p.detach().float().clone(), params)
    return state


@torch.no_grad()
def adamw_update(params, grads, state: dict, lr, *, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1):
    """Returns (params, state), both updated in place; ``lr`` may be a
    device scalar. ``grads``: a tree of the parameters' flatten order, or
    its leaves as a list."""
    step = state["step"] + 1
    t = step.float()
    bc1 = 1 - b1 ** t
    bc2 = 1 - b2 ** t
    named = T.flatten_with_path(params)
    flat_g = _flat(grads)
    flat_m, flat_v = T.leaves(state["m"]), T.leaves(state["v"])
    masters = state.get("master")
    flat_ma = T.leaves(masters) if masters is not None else [None] * len(named)
    if not len(named) == len(flat_g) == len(flat_m) == len(flat_v) == len(flat_ma):
        raise ValueError("params, grads and the optimizer state differ in their leaves")
    for (path, p), g, m, v, master in zip(named, flat_g, flat_m, flat_v, flat_ma):
        g32 = g.float()
        m_new = b1 * m + (1 - b1) * g32
        v_new = b2 * v + (1 - b2) * g32 * g32
        mhat = m_new / bc1
        vhat = v_new / bc2
        # decoupled weight decay on matrices only (stacked ndim >= 2), not norms/bias
        wd = weight_decay if T.stacked_ndim(path, p) >= 2 else 0.0
        p32 = (master if master is not None else p).float()
        p_new = p32 - lr * (mhat / (torch.sqrt(vhat) + eps) + wd * p32)
        p.copy_(p_new.to(p.dtype))
        m.copy_(m_new)
        v.copy_(v_new)
        if master is not None:
            master.copy_(p_new)
    state["step"] = step
    return params, state
