"""Quickstart on the PyTorch port: learn a causal CPDAG from observational
data — single run and bootstrap ensemble — in ~20 lines (the counterpart
of ``examples/quickstart.py``). Runs on the CUDA card; ``--device cpu``
runs the kernels' plain versions. The bootstrap's resamples come from a
``torch.Generator``, not the reference's ``jax.random`` draws.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch import pc
from repro_torch.batch import bootstrap_pc
from repro_torch.data.synthetic_dag import sample_gaussian_dag


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)

    # 1. observational data from a random linear-Gaussian SEM (paper §5.6)
    x, dag = sample_gaussian_dag(n=40, m=4_000, density=0.08, seed=7)
    true_skel = dag.skeleton()

    def skeleton_report(name, est):
        tp = int((est & true_skel).sum()) // 2
        fp = int((est & ~true_skel).sum()) // 2
        fn = int((~est & true_skel).sum()) // 2
        print(f"  [{name}] edges: {int(est.sum()) // 2} "
              f"(true: {int(true_skel.sum()) // 2})  "
              f"TDR: {tp / max(tp + fp, 1):.2%}  missed: {fn}")

    # 2. one PC-stable run with the cuPC-S engine (shared pseudo-inverse batching)
    result = pc(x, alpha=0.01, engine="S", device=args.device)
    print(f"single PC run ({result.levels_run} levels):")
    skeleton_report("single", result.adj)
    print(f"  directed in CPDAG: {int((result.cpdag & ~result.cpdag.T).sum())}")
    print("  timings:", {k: f"{v*1e3:.0f}ms" for k, v in result.timings_s.items()})

    # 3. bootstrap ensemble (repro_torch/batch/): 24 resamples learned
    #    together, aggregated by edge frequency with stability selection
    ens = bootstrap_pc(x, n_boot=24, alpha=0.01, stability_threshold=0.5,
                       max_level=3, seed=0, device=args.device)
    print(f"\nbootstrap ensemble (N={ens.n_boot}, "
          f"threshold={ens.stability_threshold}, level widths={ens.schedule}):")
    skeleton_report("ensemble", ens.adj)
    print(f"  directed in aggregated CPDAG: "
          f"{int((ens.cpdag & ~ens.cpdag.T).sum())}")

    # 4. edge frequencies separate real edges from noise: true edges recur
    #    across resamples, spurious ones don't
    iu = np.triu_indices(dag.n, 1)
    freq_true = ens.edge_freq[iu][true_skel[iu]]
    freq_false = ens.edge_freq[iu][~true_skel[iu]]
    print(f"  mean edge frequency on true edges : {freq_true.mean():.2f}")
    print(f"  mean edge frequency elsewhere     : {freq_false.mean():.3f}")
    top = sorted(ens.stable_edges(), key=lambda e: -ens.edge_freq[e])[:5]
    print("  most stable edges:",
          [(i, j, round(float(ens.edge_freq[i, j]), 2)) for i, j in top])
    print("  timings:", {k: f"{v*1e3:.0f}ms" for k, v in ens.timings_s.items()})
    return {"single": result, "ensemble": ens, "true_skeleton": true_skel,
            "freq_true": float(freq_true.mean()), "freq_false": float(freq_false.mean())}


if __name__ == "__main__":
    main()
