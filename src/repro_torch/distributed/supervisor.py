"""Fault-tolerance supervisor: checkpoint-restart and a straggler watchdog
(the counterpart of ``src/repro/distributed/supervisor.py``, kept as it is).

The training loop is driven through a supervisor that
  * checkpoints the state every ``ckpt_every`` steps through the async
    ``CheckpointManager``,
  * catches step failures (preemption and device loss surface as Python
    exceptions), restores the latest checkpoint and replays: the data
    pipeline is cursor-addressable, so replayed batches are bit-identical,
    and a replayed step's metrics are appended to the history again, as
    the reference's are,
  * tracks a per-step wall-time EMA on the ``obs`` clock; a step slower
    than ``straggler_factor ×`` the EMA is counted and reported through
    ``on_straggler``.

It sees an opaque state tree and a step callable.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..checkpoint import CheckpointManager
from ..obs import MonotonicClock


@dataclass
class TrainResult:
    steps_done: int
    restarts: int
    stragglers: int
    metrics_history: list = field(default_factory=list)


class Supervisor:
    def __init__(
        self,
        ckpt: CheckpointManager,
        ckpt_every: int = 50,
        max_restarts: int = 3,
        straggler_factor: float = 3.0,
        on_straggler=None,
        clock=None,
    ):
        self.ckpt = ckpt
        self.ckpt_every = ckpt_every
        self.max_restarts = max_restarts
        self.straggler_factor = straggler_factor
        self.on_straggler = on_straggler or (lambda step, dt, ema: None)
        # obs clock seam: tests inject ManualClock to script straggler steps
        self.clock = clock or MonotonicClock()

    def run(self, state, step_fn, batch_fn, n_steps: int, start_step: int = 0) -> TrainResult:
        """state: opaque tree. step_fn(state, batch) -> (state, metrics).
        batch_fn(step) -> batch (cursor-addressable: replay-exact)."""
        restored, ck_step = self.ckpt.restore(state)
        if restored is not None:
            state, start_step = restored, ck_step + 1

        restarts = stragglers = 0
        ema = None
        history = []
        step = start_step
        while step < n_steps:
            try:
                t0 = self.clock.now()
                state, metrics = step_fn(state, batch_fn(step))
                dt = self.clock.now() - t0
                if ema is not None and dt > self.straggler_factor * ema:
                    stragglers += 1
                    self.on_straggler(step, dt, ema)
                ema = dt if ema is None else 0.9 * ema + 0.1 * dt
                history.append(metrics)
                if (step + 1) % self.ckpt_every == 0 or step + 1 == n_steps:
                    self.ckpt.save(step, state)
                step += 1
            except Exception:
                restarts += 1
                if restarts > self.max_restarts:
                    raise
                restored, ck_step = self.ckpt.restore(state)
                if restored is None:
                    step = start_step  # no checkpoint yet: replay from start
                else:
                    state, step = restored, ck_step + 1
        self.ckpt.wait()
        return TrainResult(step, restarts, stragglers, history)
