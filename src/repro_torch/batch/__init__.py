"""Batched PC and the bootstrap ensemble: port of ``src/repro/batch/``.

cuPC parallelises one PC run across CI tests; real deployments run PC
many times: bootstrap replicates, α sweeps, many small per-module
datasets (ParallelPC, arXiv 1510.03042). This package provides:

  scan_pc.pc_scan        PC-stable with static shapes up to a level cap,
                         recorded CUDA graphs on the card; equal to the
                         "S-kernel" engine there and to "S" on the CPU.
  scan_pc.pc_scan_batch  the same program over a leading batch of
                         correlation matrices: B graphs a replay.
  ensemble.bootstrap_pc  bootstrap resampling → per-replicate correlation
                         → batched scan → edge-frequency aggregation and
                         the stability-selected CPDAG.
"""
from .ensemble import EnsembleRun, bootstrap_corr, bootstrap_pc
from .scan_pc import (
    ScanResult,
    pc_scan,
    pc_scan_batch,
    plan_n_prime,
    plan_schedule,
    scan_levels_batch,
)

__all__ = [
    "EnsembleRun",
    "ScanResult",
    "bootstrap_corr",
    "bootstrap_pc",
    "pc_scan",
    "pc_scan_batch",
    "plan_n_prime",
    "plan_schedule",
    "scan_levels_batch",
]
