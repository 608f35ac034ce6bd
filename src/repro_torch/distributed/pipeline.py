"""Pipeline parallelism: a GPipe-style stage runner over a ``pipe`` axis of
a named mesh (the counterpart of ``src/repro/distributed/pipeline.py``).

Stage s lives on the device of the mesh's rank s along ``pipe`` (the other
axes at 0). Microbatches stream through the S-deep pipeline in M + S - 1
ticks: rank 0 injects microbatch t at tick t, each rank passes its output
to the next (the reference's ``ppermute``: a copy to the next rank's
device), and rank S - 1 emits microbatch t - (S - 1). The masking is the
reference's: rank 0's output is zero once the stream is spent, and ranks
past 0 run on their buffer at every tick (zeros before their first
microbatch arrives). The runner is forward code; autograd through the
ticks gives the backward, as ``jax.grad`` through the reference's scan
does, with no hand-written adjoint.
"""
from __future__ import annotations

import torch

from .. import tree as T


def _stage_device(mesh, axis: str, s: int) -> torch.device:
    return mesh.require_devices()[mesh.rank(**{axis: s})]


def pipeline_apply(stage_fn, stage_params, xs: torch.Tensor, mesh, axis: str = "pipe"):
    """``stage_fn(params_one_stage, x_mb) -> x_mb``. ``stage_params``: a tree
    whose leaves have a leading stage dimension S (``split_stages``); stage
    s's slice runs on its rank's device. ``xs``: (M, mb, ...) microbatches.
    Returns the (M, mb, ...) outputs on the last rank's device."""
    s_total = mesh.shape[axis]
    m = xs.shape[0]
    devs = [_stage_device(mesh, axis, s) for s in range(s_total)]
    params = [T.tree_map(lambda x, s=s: x[s].to(devs[s]), stage_params)
              for s in range(s_total)]
    zero = xs[0].new_zeros(xs.shape[1:])
    buf = [zero.to(dev) for dev in devs]
    outs: list = [None] * m
    for t in range(m + s_total - 1):
        nxt = [None] * s_total
        for rank in range(s_total):
            inp = xs[min(t, m - 1)].to(devs[0]) if rank == 0 else buf[rank]
            valid_in = t < m or rank > 0
            out = stage_fn(params[rank], inp) if valid_in else torch.zeros_like(inp)
            done = t - (s_total - 1)
            if rank == s_total - 1 and done >= 0:
                outs[done] = out
            nxt[(rank + 1) % s_total] = out.to(devs[(rank + 1) % s_total])
        buf = nxt
    return torch.stack(outs)


def split_stages(layer_params, n_stages: int):
    """Stacked layer parameters (L, ...) -> (S, L/S, ...)."""

    def one(x):
        n = x.shape[0]
        if n % n_stages:
            raise ValueError(f"layers {n} % stages {n_stages} != 0")
        return x.reshape(n_stages, n // n_stages, *x.shape[1:])

    return T.tree_map(one, layer_params)
