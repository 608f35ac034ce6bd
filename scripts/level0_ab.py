#!/usr/bin/env python3
"""Time one checkout's level-0 span on the card: the kernel entries and
the ``level0`` span of ``pc(x)`` end to end.

    python3 scripts/level0_ab.py [--src DIR] [--runs N] [--label NAME]

``--src`` is the ``src`` directory of the checkout to time (default: this
one's), so that one copy of the script times a parent and a change
unpacked side by side with ``git archive``; run them in turns (parent,
change, change, parent, ...) in one call, since two calls may land on
two cards. On NCI-60's C (n = 1190, m = 47) and the §5.6 instance's
(n = 1000, m = 10 000), the seeded stand-ins of ``chip_smoke.py``, it
times with CUDA events (``cuda_ms``: 20 calls back to back) and inside a
CUDA graph (``graph_ms``: the device time alone):

  adjacency  ``kernels/level0.py::level0_kernel``, the adjacency entry;
  old span   that entry and the six PyTorch ops of the level-0 span
             before it was fused (``chip_smoke.level0_old_span``);
  fused      ``kernels/level0.py::level0_span``, where the checkout has it;

then runs ``pc(x)`` ("auto") ``--runs`` times on each instance after one
warm-up run and prints each run's ``timings_s["level0"]`` and total. The
last line is one JSON object with every number.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
DEPTH = 8


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--label", default="")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("level0_ab: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    warnings.simplefilter("ignore", UserWarning)
    torch.backends.cuda.matmul.allow_tf32 = False

    import chip_smoke as cs
    from repro_torch import pc
    from repro_torch.core.cit import threshold
    from repro_torch.data.synthetic_dag import sample_gaussian_dag
    from repro_torch.kernels import build, level0, ops

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    build.library()
    out = {"label": args.label, "src": args.src, "card": smi, "kernels": {}, "e2e": {}}
    fused = getattr(level0, "level0_span", None)
    for name, cfg in (("NCI-60", cs.NCI60), ("§5.6", cs.S56)):
        x_np, _ = sample_gaussian_dag(cfg["n"], cfg["m"], cfg["density"], seed=cfg["seed"])
        c = ops.correlation(torch.tensor(x_np, dtype=torch.float32, device="cuda"))
        tau = threshold(cfg["m"], 0, cfg["alpha"])
        fns = [("adjacency", lambda: level0.level0_kernel(c, tau)),
               ("old span", lambda: cs.level0_old_span(torch, level0, c, tau, DEPTH))]
        if fused is not None:
            fns.append(("fused", lambda: fused(c, tau, DEPTH)))
        times = {k: {"cuda_ms": cs.cuda_ms(torch, fn), "graph_ms": cs.graph_ms(torch, fn)}
                 for k, fn in fns}
        out["kernels"][name] = times
        print(f"{args.label} {name} n={cfg['n']}: " + ", ".join(
            f"{k} {v['cuda_ms']:.5f} / graph {v['graph_ms']:.5f} ms" for k, v in times.items()))

        pc(x_np, alpha=cfg["alpha"])  # warm-up: PyTorch's CUDA modules load
        level0_s, total_s = [], []
        for _ in range(args.runs):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            run = pc(x_np, alpha=cfg["alpha"])
            torch.cuda.synchronize()
            total_s.append(time.monotonic() - t0)
            level0_s.append(run.timings_s["level0"])
        out["e2e"][name] = {"level0_s": level0_s, "total_s": total_s}
        print(f"{args.label} {name} pc(x) auto: level0 span s "
              + " ".join(f"{v:.6f}" for v in level0_s) + "; total s "
              + " ".join(f"{v:.4f}" for v in total_s))
    print(smi)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
