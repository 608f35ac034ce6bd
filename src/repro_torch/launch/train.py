"""End-to-end training driver (the port of ``src/repro/launch/train.py``).

    python -m repro_torch.launch.train --arch qwen3-1.7b --reduced \\
        --steps 200 --batch 8 --seq 128 --ckpt DIR --device cpu
    python -m repro_torch.launch.train --arch qwen3-1.7b --steps 20    # full width, on the card

``--reduced`` runs the same path at smoke scale in fp32 compute; full
width computes in bf16 with fp32 parameters. Fault tolerance is live: the
``Supervisor`` checkpoints asynchronously and replays from the latest
checkpoint on a failure (``--inject-failure N`` raises one when the
optimizer reaches step N). ``--history PATH`` writes every recorded loss
(replayed steps again, as the supervisor records them) as JSON, with the
restart and straggler counts. Parameters are drawn from a generator
seeded 0 and batches from ``TokenPipeline`` (seed 0): the reference's
seeds, not its draws. The launcher trains the decoder families; Whisper's
batches carry frames, and it trains through ``registry.make_train_step``.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import torch

from .. import tree as T
from ..checkpoint import CheckpointManager
from ..configs import ARCHS, TrainConfig
from ..data.lm_tokens import TokenPipeline
from ..device import resolve_device
from ..distributed import Supervisor
from ..models import registry as R
from ..obs import MonotonicClock
from ..optim import adamw_init

_CLK = MonotonicClock()  # the obs timing seam — no raw perf_counter (RPR003)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="qwen3-1.7b", choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default=str(Path(tempfile.gettempdir()) / "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--inject-failure", type=int, default=0,
                    help="raise a fake failure at this step (FT demo)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="cpu, or a CUDA device (default: the card)")
    ap.add_argument("--history", default=None, help="write the loss history here (JSON)")
    args = ap.parse_args(argv)

    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.family == "audio":
        raise SystemExit("the launcher trains decoder-only archs; Whisper's batches carry "
                         "frames: train it through repro_torch.models.registry.make_train_step")
    tcfg = TrainConfig(lr=args.lr, total_steps=args.steps, warmup=max(args.steps // 20, 5),
                       compute_dtype="float32" if args.reduced else "bfloat16")

    dev = resolve_device(args.device)
    api = R.build(cfg, compute_dtype=getattr(torch, tcfg.compute_dtype), device=dev)
    params = api.init()  # seed 0, the reference's init key
    opt = adamw_init(params)
    n_params = sum(x.numel() for x in T.leaves(params))
    print(f"[train] {cfg.name}{' (reduced)' if args.reduced else ''}: "
          f"{n_params/1e6:.1f}M params, {args.steps} steps, "
          f"batch {args.batch} x seq {args.seq}")

    train_step = R.make_train_step(cfg, tcfg, device=dev)
    pipe = TokenPipeline(cfg.vocab, args.seq, args.batch, device=dev)

    fail_at = {"step": args.inject_failure, "armed": args.inject_failure > 0}

    def step_fn(state, batch):
        params, opt = state
        if fail_at["armed"] and int(opt["step"]) >= fail_at["step"]:
            fail_at["armed"] = False
            raise RuntimeError("injected node failure")
        params, opt, metrics = train_step(params, opt, batch)
        return (params, opt), metrics

    sup = Supervisor(CheckpointManager(args.ckpt), ckpt_every=args.ckpt_every)
    t0 = _CLK.now()
    res = sup.run((params, opt), step_fn, pipe.batch, args.steps)
    dt = _CLK.now() - t0

    losses = [float(m["loss"]) for m in res.metrics_history]
    for i in range(0, len(losses), args.log_every):
        print(f"  step {i:5d}  loss {losses[i]:.4f}")
    print(f"[train] done: {res.steps_done} steps in {dt:.1f}s "
          f"({res.restarts} restarts, {res.stragglers} stragglers)  "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    if args.history:
        Path(args.history).write_text(json.dumps({
            "losses": losses, "steps_done": res.steps_done, "restarts": res.restarts,
            "stragglers": res.stragglers, "seconds": dt}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
