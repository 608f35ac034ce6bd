"""Launcher for the paper's workload: PC-stable causal discovery on the
CUDA card (the port of ``src/repro/launch/pc_run.py``).

    python -m repro_torch.launch.pc_run --n 500 --m 10000 --d 0.1 --engine auto --alpha 0.01
    python -m repro_torch.launch.pc_run --dataset NCI-60 --json out.json
    python -m repro_torch.launch.pc_run --n 40 --m 2000 --d 0.15 --device cpu

``--engine`` selects the level engine (``core/engines.py``): cuPC-S/-E as
PyTorch ops ("S"/"E"), the fused S-kernel a chunk ("S-kernel"), the
grid-resident cuPC-S kernel ("S-grid"), the dense ℓ = 1 kernel
("L1-dense"), the default hybrid ("auto": L1-dense at ℓ = 1, S-kernel at
ℓ ≥ 2) or the whole run as one recorded fixed-shape program ("scan",
static level cap ``--max-level``). ``--corr`` picks C's path: the corr
kernel or the plain PyTorch version ("auto": the kernel on the card).
Combo ranks are int64 (``wide_ranks=True``), as the reference launcher's
``jax_enable_x64`` makes them.

Many-graph modes (``repro_torch.batch``): ``--batch B`` learns B
synthetic datasets (seeds ``--seed`` + b) through ``pc_scan_batch`` at a
planned schedule and reports graphs/s of a steady call; ``--bootstrap N``
runs the bootstrap ensemble on the configured dataset and reports edge
frequencies and the stability-selected CPDAG.

``--journal PATH`` turns obs on for the run and writes its spans to PATH
(JSONL).

Multi-device (``core/distributed.py``, ``core/sharding.py``), the
reference's flags: ``--devices K`` runs the row-sharded distributed
engine on K devices (the first K cards; with ``--device cpu``, K logical
CPU shards); ``--shard-c`` row-shards C as well, with a per-run
hot-column cache (``--no-cache-cols`` gathers the columns every chunk);
``--shard-sep`` row-shards the sepset tensor; ``--pipeline-depth D``
keeps D chunks' tests in flight; ``--speculate`` (with ``--engine
S-grid``) issues each level's first launch before the level's max-degree
read resolves. ``--mesh K`` builds a K-device mesh; ``--shard-batch``
shards the B axis of ``--batch``/``--bootstrap`` over it (all visible
cards, or ``--devices``/``--mesh`` shards).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys

import numpy as np

from ..obs import MonotonicClock

_CLK = MonotonicClock()  # the obs timing seam


def _sync(device, mesh=None) -> None:
    import torch

    for dev in (mesh.distinct() if mesh is not None else (device,)):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def _batch_mesh(args, device):
    """The mesh of --shard-batch runs (None when sharding is off): --mesh
    or --devices shards, else every visible card."""
    if not args.shard_batch:
        return None
    from ..core.sharding import make_mesh, mesh_size

    mesh = make_mesh(args.mesh or args.devices or None, device=device)
    print(f"[pc_run] batch axis sharded over {mesh_size(mesh)} devices")
    return mesh


def _run_bootstrap(args, x, n, m, d, alpha, device):
    """--bootstrap N: the ensemble on the configured dataset."""
    from ..batch.ensemble import bootstrap_pc

    mesh = _batch_mesh(args, device)
    t0 = _CLK.now()
    run = bootstrap_pc(x, n_boot=args.bootstrap, alpha=alpha,
                       stability_threshold=args.stability_threshold, max_level=args.max_level,
                       seed=args.seed, corr=args.corr, mesh=mesh, device=device)
    dt = _CLK.now() - t0
    freq = run.edge_freq[np.triu_indices(n, 1)]
    n_stable = len(run.stable_edges())
    print(f"[pc_run] bootstrap N={run.n_boot} threshold={run.stability_threshold}"
          f" widths={run.schedule}")
    print(f"  stable skeleton edges: {n_stable};  mean replicate edges: "
          f"{run.replicate_adj.sum(axis=(1, 2)).mean() / 2:.1f}")
    print(f"  edge-freq deciles (non-zero pairs): "
          f"{np.percentile(freq[freq > 0], [10, 50, 90]).round(2).tolist()}"
          if (freq > 0).any() else "  no edges in any replicate")
    print(f"  directed in aggregated CPDAG: {int((run.cpdag & ~run.cpdag.T).sum())}")
    for k, v in run.timings_s.items():
        print(f"  {k:>16s}: {v*1e3:9.1f} ms")
    print(f"  total: {dt:.2f} s")
    if args.json:
        _write(args.json, {
            "mode": "bootstrap", "n": n, "m": m, "density": d, "n_boot": run.n_boot,
            "stability_threshold": run.stability_threshold, "stable_edges": n_stable,
            "timings_s": run.timings_s, "total_s": dt,
        })


def _run_batch(args, n, m, d, alpha, device):
    """--batch B: B synthetic datasets through one ``pc_scan_batch`` call
    at the schedule ``plan_schedule`` finds, timed after a first call;
    sharded over the mesh with --shard-batch."""
    import torch

    from ..batch.scan_pc import DEFAULT_MAX_LEVEL, plan_schedule
    from ..core.cit import correlation_of
    from ..core.engines import batch_run
    from ..data.synthetic_dag import sample_gaussian_dag

    cs = torch.stack([
        correlation_of(torch.tensor(sample_gaussian_dag(n=n, m=m, density=d, seed=args.seed + b)[0],
                                    dtype=torch.float32, device=device), args.corr)
        for b in range(args.batch)
    ])
    mesh = _batch_mesh(args, device)
    max_level = args.max_level if args.max_level is not None else DEFAULT_MAX_LEVEL
    schedule = plan_schedule(cs, m, alpha=alpha, max_level=max_level, mesh=mesh, device=device)
    run = dict(alpha=alpha, max_level=max_level, n_prime=schedule, mesh=mesh, device=device)
    res = batch_run(cs, m, **run)
    _sync(device, mesh)  # the first call (on the card: the programs' recording)
    t0 = _CLK.now()
    res = batch_run(cs, m, **run)
    _sync(device, mesh)
    dt = _CLK.now() - t0
    edges = res.adj.sum(dim=(1, 2)).cpu().numpy() // 2
    print(f"[pc_run] batch B={args.batch} max_level={max_level} widths={schedule}")
    print(f"  edges per graph: min={int(edges.min())} mean={edges.mean():.1f} "
          f"max={int(edges.max())};  exact: {int(res.ok.sum())}/{args.batch}")
    print(f"  steady-state: {dt:.3f} s -> {args.batch / dt:.1f} graphs/sec")
    if args.json:
        _write(args.json, {
            "mode": "batch", "n": n, "m": m, "density": d, "batch": args.batch,
            "schedule": list(schedule), "max_level": max_level, "steady_s": dt,
            "graphs_per_s": args.batch / dt,
        })


def _write(path: str, rec: dict) -> None:
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.pc_run")
    ap.add_argument("--dataset", default=None, help="paper Table-1 dataset name")
    ap.add_argument("--n", type=int, default=500)
    ap.add_argument("--m", type=int, default=10_000)
    ap.add_argument("--d", type=float, default=0.1)
    ap.add_argument("--alpha", type=float, default=0.01)
    ap.add_argument(
        "--engine", default="auto",
        choices=["E", "S", "S-kernel", "S-grid", "L1-dense", "auto", "scan"],
        help="level engine: cuPC-E/-S as PyTorch ops, the fused S-kernel a chunk (S-kernel), "
             "the grid-resident cuPC-S kernel (S-grid), the dense l=1 kernel (L1-dense), the "
             "auto hybrid (L1-dense at l=1 + S-kernel at l>=2), or scan (the whole run as one "
             "recorded fixed-shape program; static level cap = --max-level, defaulting to the "
             "scan path's DEFAULT_MAX_LEVEL)")
    ap.add_argument("--corr", default="auto", choices=["auto", "kernel", "plain"],
                    help="correlation matrix path: the corr kernel or the plain PyTorch "
                         "version (auto = the kernel on the card, plain on the CPU)")
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card (cpu runs the plain versions)")
    ap.add_argument("--no-bucket", action="store_true",
                    help="plan each level at its exact max degree instead of its bucket")
    ap.add_argument("--max-level", type=int, default=None)
    ap.add_argument("--pipeline-depth", type=int, default=1,
                    help=">=2: keep that many rank chunks' CI tests queued ahead of their "
                         "commits on the S worklist (equal results at any depth)")
    ap.add_argument("--batch", type=int, default=0,
                    help=">0: learn B synthetic datasets in one pc_scan_batch call and report "
                         "graphs/sec")
    ap.add_argument("--bootstrap", type=int, default=0,
                    help=">0: bootstrap-ensemble PC with N replicates (batch/ensemble.py)")
    ap.add_argument("--stability-threshold", type=float, default=0.5,
                    help="edge-frequency cutoff of the bootstrap ensemble's stability-selected "
                         "skeleton")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None)
    ap.add_argument("--journal", default=None, metavar="PATH",
                    help="enable obs and write the run's trace spans to PATH (JSONL)")
    ap.add_argument("--devices", type=int, default=0,
                    help=">0: distributed over rows on K devices (with --device cpu, K "
                         "logical CPU shards)")
    ap.add_argument("--mesh", type=int, default=0,
                    help=">0: build a flat K-device mesh (core/sharding.py) for the sharded "
                         "paths; 0 uses all visible cards when a sharded flag asks for one")
    ap.add_argument("--shard-batch", action="store_true",
                    help="shard the leading B axis of --batch/--bootstrap over the mesh")
    ap.add_argument("--shard-c", action="store_true",
                    help="row-shard the correlation matrix in the distributed engine "
                         "(per-device C memory O(n*k + n^2/n_dev) instead of O(n^2))")
    ap.add_argument("--shard-sep", action="store_true",
                    help="row-shard the sepset tensor in the distributed engine and commit "
                         "winners shard-locally (O(n^2*depth/n_dev) a device)")
    ap.add_argument("--speculate", action="store_true",
                    help="with --devices/--mesh and --engine S-grid: issue level l+1's first "
                         "launch under level l's width before the max-degree read resolves "
                         "(equal results)")
    ap.add_argument("--no-cache-cols", action="store_true",
                    help="disable the per-run hot-column cache of --shard-c runs (gather "
                         "C[:, cols] in every chunk)")
    return ap


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    from .. import device as D
    from .. import obs

    device = D.resolve_device(args.device)
    scope = (obs.scoped(enabled=True, journal_path=args.journal) if args.journal
             else contextlib.nullcontext())
    with scope:
        _main(args, device)
    return 0


def _main(args, device) -> None:
    from ..configs.cupc_datasets import CUPC_DATASETS
    from ..data.synthetic_dag import sample_gaussian_dag

    if args.dataset:
        ds = CUPC_DATASETS[args.dataset]
        n, m, d, alpha = ds.n, ds.m, ds.density, ds.alpha
    else:
        n, m, d, alpha = args.n, args.m, args.d, args.alpha

    print(f"[pc_run] n={n} m={m} density={d} engine=cuPC-{args.engine}"
          + (f" devices={args.devices}" if args.devices else ""))

    if args.batch:  # generates its own B datasets; skip the single-run one
        _run_batch(args, n, m, d, alpha, device)
        return
    x, _dag = sample_gaussian_dag(n=n, m=m, density=d, seed=args.seed)
    if args.bootstrap:
        _run_bootstrap(args, x, n, m, d, alpha, device)
        return

    t0 = _CLK.now()
    if args.devices or args.mesh or args.shard_c or args.shard_sep:
        run = _run_distributed(args, x, alpha, device)
    else:
        from ..core.pc import pc

        run = pc(x, alpha=alpha, engine=args.engine, max_level=args.max_level, corr=args.corr,
                 bucket=not args.no_bucket, pipeline_depth=args.pipeline_depth, device=device,
                 wide_ranks=True)
    dt = _CLK.now() - t0

    n_edges = int(run.adj.sum()) // 2
    n_directed = int((run.cpdag & ~run.cpdag.T).sum())
    print(f"  levels run: {run.levels_run};  skeleton edges: {n_edges};"
          f"  directed in CPDAG: {n_directed}")
    for k, v in run.timings_s.items():
        print(f"  {k:>8s}: {v*1e3:9.1f} ms")
    print(f"  total: {dt:.2f} s")

    if args.json:
        _write(args.json, {
            "n": n, "m": m, "density": d, "engine": args.engine, "edges": n_edges,
            "levels": run.levels_run, "timings_s": run.timings_s, "total_s": dt,
        })


def _run_distributed(args, x, alpha, device):
    """--devices/--mesh/--shard-c/--shard-sep: ``pc_distributed`` over the
    mesh, with the reference launcher's lines."""
    from ..core.distributed import pc_distributed
    from ..core.sharding import mesh_size
    from .mesh import make_pc_mesh

    dist_engine = args.engine if args.engine in ("S", "S-grid") else "S"
    if args.engine not in ("auto", "S", "S-grid"):
        print("[pc_run] note: --devices supports --engine S / S-grid (sharded cuPC-S); "
              "other --engine selections apply to single-device runs only")
    if args.speculate and dist_engine != "S-grid":
        print("[pc_run] warning: --speculate requires --engine S-grid; ignoring it for this "
              "run")
    mesh = make_pc_mesh(args.devices or args.mesh or None, device=device)
    if dist_engine == "S-grid":
        print("[pc_run] grid-resident engine: one fused tests+commit launch per level"
              + (" + speculative next-level dispatch" if args.speculate else ""))
    if args.shard_c:
        print(f"[pc_run] correlation matrix row-sharded over {mesh_size(mesh)} devices"
              + (" (hot-column cache off)" if args.no_cache_cols else ""))
    if args.shard_sep:
        print(f"[pc_run] sepset tensor row-sharded over {mesh_size(mesh)} devices "
              "(shard-local commit)")
    if args.pipeline_depth > 1:
        print(f"[pc_run] chunk dispatch pipelined, depth {args.pipeline_depth}")
    return pc_distributed(x, alpha=alpha, mesh=mesh, max_level=args.max_level,
                          bucket=not args.no_bucket, shard_c=args.shard_c,
                          shard_sep=args.shard_sep, cache_cols=not args.no_cache_cols,
                          pipeline_depth=args.pipeline_depth, engine=dist_engine,
                          speculate=args.speculate and dist_engine == "S-grid",
                          corr=args.corr, wide_ranks=True)


if __name__ == "__main__":
    sys.exit(main())
