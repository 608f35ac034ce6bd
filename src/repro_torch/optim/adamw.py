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
    gn, scale = norm_and_scale([g.float().square().sum() for g in flat], groups, max_norm)
    out = [(g.float() * scale).to(g.dtype) for g in flat]
    return (out if flat is grads else T.unflatten_like(grads, out)), gn


def norm_and_scale(sq: list, groups: list, max_norm: float):
    """(the global norm, the clip factor) from each leaf's squared sum,
    ``groups`` (``tree.stacked_groups``) adding a stack's layers into their
    stacked leaf first, the leaves in the reference's flatten order."""
    total = None
    for group in groups:
        part = sq[group[0]]
        for i in group[1:]:
            part = part + sq[i]
        total = part if total is None else total + part
    gn = torch.sqrt(total)
    return gn, torch.clamp(max_norm / gn.clamp_min(1e-9), max=1.0)


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


#: the most elements one multi-tensor group of the update holds (fp32: 512
#: MiB a temporary); a larger leaf is a group of its own
GROUP_ELEMENTS = 1 << 27


def _groups(sizes: list, limit: int) -> list[list[int]]:
    out, cur, n = [], [], 0
    for i, size in enumerate(sizes):
        if cur and n + size > limit:
            out.append(cur)
            cur, n = [], 0
        cur.append(i)
        n += size
    return out + [cur] if cur else out


@torch.no_grad()
def adamw_update(params, grads, state: dict, lr, *, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1):
    """Returns (params, state), both updated in place; ``lr`` may be a
    device scalar. ``grads``: a tree of the parameters' flatten order, or
    its leaves as a list. The leaves go in groups of at most
    ``GROUP_ELEMENTS``, each step of the update one multi-tensor
    (``torch._foreach_*``) op over a group: the same elementwise arithmetic,
    in the same order, as one op a leaf, with at most three temporaries of
    a group's size alive."""
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
    # decoupled weight decay on matrices only (stacked ndim >= 2), not norms/bias
    wd = [weight_decay if T.stacked_ndim(path, p) >= 2 else 0.0 for path, p in named]
    ps = [p for _, p in named]
    for idx in _groups([p.numel() for p in ps], GROUP_ELEMENTS):
        def pick(xs):
            return [xs[i] for i in idx]

        _update_group(pick(ps), pick(flat_g), pick(flat_m), pick(flat_v), pick(flat_ma),
                      pick(wd), lr, bc1, bc2, b1, b2, eps)
    state["step"] = step
    return params, state


def _update_group(ps, gs, ms, vs, mas, wds, lr, bc1, bc2, b1, b2, eps):
    f = torch
    g32 = [g.float() for g in gs]
    tmp = f._foreach_mul(g32, 1 - b1)
    f._foreach_mul_(ms, b1)
    f._foreach_add_(ms, tmp)                      # m ← b1·m + (1 − b1)·g
    tmp = f._foreach_mul(g32, 1 - b2)
    f._foreach_mul_(tmp, g32)
    f._foreach_mul_(vs, b2)
    f._foreach_add_(vs, tmp)                      # v ← b2·v + (1 − b2)·g·g
    del tmp, g32
    upd = f._foreach_div(ms, bc1)                 # m̂
    den = f._foreach_div(vs, bc2)                 # v̂
    f._foreach_sqrt_(den)
    f._foreach_add_(den, eps)
    f._foreach_div_(upd, den)                     # m̂ / (√v̂ + eps)
    del den
    held = [ma if ma is not None else p for p, ma in zip(ps, mas)]
    p32 = [x.float() for x in held]
    f._foreach_add_(upd, f._foreach_mul(p32, wds))
    f._foreach_mul_(upd, lr)                      # lr · (m̂ / (√v̂ + eps) + wd·p)
    if all(a is b for a, b in zip(p32, held)):    # the fp32 truth, updated in place
        f._foreach_sub_(p32, upd)
        p_new = p32
    else:
        p_new = f._foreach_sub(p32, upd)
        f._foreach_copy_(held, p_new)
    if mas[0] is not None:
        f._foreach_copy_(ps, p_new)
