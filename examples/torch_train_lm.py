"""Train a ~100M-param LM for a few hundred steps on the PyTorch port (the
counterpart of ``examples/train_lm.py``): the framework's end-to-end
training path (data pipeline → model → AdamW → async checkpointing →
fault-tolerant supervisor). Runs on the CUDA card; ``--device cpu`` runs
on the CPU. ``main(argv, cfg=...)`` trains another (e.g. narrower) config.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 300] [--device cpu]
"""
import argparse
import dataclasses
import tempfile
import time

import torch

from repro_torch import tree as T
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCHS, TrainConfig
from repro_torch.data.lm_tokens import TokenPipeline
from repro_torch.distributed import Supervisor
from repro_torch.models import registry as R
from repro_torch.optim import adamw_init


def main(argv=None, cfg=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default=None, help="checkpoint directory (default: a new "
                    "temporary one; an existing checkpoint there is resumed)")
    ap.add_argument("--device", default=None, help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)

    # ~100M params: qwen3 family geometry at width 512 / 8 layers / 32k vocab
    cfg = cfg or dataclasses.replace(
        ARCHS["qwen3-1.7b"],
        name="qwen3-100m",
        n_layers=8, d_model=512, n_heads=8, n_kv=4, d_head=64,
        d_ff=2048, vocab=32_768, tie_embed=False,
    )
    tcfg = TrainConfig(lr=3e-4, warmup=20, total_steps=args.steps,
                       compute_dtype="float32", grad_accum=1)

    api = R.build(cfg, compute_dtype=torch.float32, device=args.device)
    params = api.init()
    opt = adamw_init(params)
    n = sum(x.numel() for x in T.leaves(params))
    print(f"[train_lm] {cfg.name}: {n/1e6:.1f}M params, {args.steps} steps")

    step = R.make_train_step(cfg, tcfg, device=args.device)
    pipe = TokenPipeline(cfg.vocab, args.seq, args.batch, device=args.device)

    def step_fn(state, batch):
        p, o = state
        p, o, m = step(p, o, batch)
        return (p, o), m

    ckpt = args.ckpt or tempfile.mkdtemp(prefix="train_lm_ckpt")
    sup = Supervisor(CheckpointManager(ckpt), ckpt_every=100)
    t0 = time.perf_counter()
    res = sup.run((params, opt), step_fn, pipe.batch, args.steps)
    dt = time.perf_counter() - t0

    losses = [float(m["loss"]) for m in res.metrics_history]
    for i in list(range(0, len(losses), 50)) + [len(losses) - 1]:
        print(f"  step {i:4d}  loss {losses[i]:.4f}")
    tput = args.steps * args.batch * args.seq / dt
    print(f"[train_lm] {dt:.0f}s  ({tput:.0f} tok/s)  loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    if losses[-1] >= losses[0]:
        raise SystemExit("loss did not decrease!")
    return {"losses": losses, "seconds": dt, "n_params": n}


if __name__ == "__main__":
    main()
