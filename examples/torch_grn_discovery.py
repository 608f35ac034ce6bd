"""End-to-end driver on the PyTorch port (the counterpart of
``examples/grn_discovery.py``): gene-regulatory-network-style causal
discovery on a DREAM5-Insilico-shaped dataset, with both engines, accuracy
against the generating DAG, and per-level timing. The data is the port's
numpy-seeded ``sample_gaussian_dag``, so it is the reference's data, and
``--serial-check`` holds the skeleton to the serial oracle. Runs on the
CUDA card; ``--device cpu`` runs the kernels' plain versions.

    PYTHONPATH=src python examples/torch_grn_discovery.py [--n 400] [--m 850] [--device cpu]
"""
import argparse
import time

import numpy as np

from repro_torch import pc
from repro_torch.core.stable_ref import pc_stable_skeleton
from repro_torch.data.synthetic_dag import sample_gaussian_dag


def shd(est: np.ndarray, true: np.ndarray) -> int:
    """Structural Hamming distance between skeletons."""
    diff = est ^ true
    return int(diff.sum()) // 2


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=400)
    ap.add_argument("--m", type=int, default=850)
    ap.add_argument("--density", type=float, default=0.02)
    ap.add_argument("--alpha", type=float, default=0.01)
    ap.add_argument("--serial-check", action="store_true",
                    help="also run the python serial oracle (slow)")
    ap.add_argument("--device", default=None, help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)

    print(f"[grn] sampling expression-like data: n={args.n} genes, m={args.m} samples")
    x, dag = sample_gaussian_dag(n=args.n, m=args.m, density=args.density, seed=42)
    true_skel = dag.skeleton()

    runs = {}
    for engine in ("E", "S"):
        t0 = time.perf_counter()
        r = pc(x, alpha=args.alpha, engine=engine, device=args.device)
        dt = time.perf_counter() - t0
        runs[engine] = (r, dt)
        est = r.adj
        tp = int((est & true_skel).sum()) // 2
        fp = int((est & ~true_skel).sum()) // 2
        print(f"\n[cuPC-{engine}] total {dt:.2f}s  levels={r.levels_run}")
        for k, v in r.timings_s.items():
            if k.startswith("level"):
                print(f"    {k}: {v*1e3:8.1f} ms")
        print(f"    edges={int(est.sum())//2} TDR={tp/max(tp+fp,1):.2%} "
              f"SHD={shd(est, true_skel)} "
              f"v-structures+Meek oriented {int((r.cpdag & ~r.cpdag.T).sum())} edges")

    if not np.array_equal(runs["E"][0].adj, runs["S"][0].adj):
        raise SystemExit("E/S disagree!")
    print("\n[grn] cuPC-E and cuPC-S skeletons identical ✓")

    out = {"E": runs["E"][0], "S": runs["S"][0], "serial": None}
    if args.serial_check:
        t0 = time.perf_counter()
        ref = pc_stable_skeleton(np.corrcoef(x.T), args.m, args.alpha)
        dt_serial = time.perf_counter() - t0
        if not np.array_equal(ref.adj, runs["S"][0].adj):
            raise SystemExit("engine != serial oracle!")
        out["serial"] = ref
        print(f"[grn] serial oracle matches ✓  ({dt_serial:.1f}s serial vs "
              f"{runs['S'][1]:.1f}s cuPC-S → {dt_serial/runs['S'][1]:.0f}x)")
    return out


if __name__ == "__main__":
    main()
