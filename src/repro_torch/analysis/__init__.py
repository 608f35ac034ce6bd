"""The port's contract suite: the counterpart of ``src/repro/analysis``,
sweeping and tracing ``src/repro_torch`` only.

Three layers, one CLI (``python -m repro_torch.analysis``), one committed
baseline (``analysis_baseline_torch.json``):

  * Layer 1 (:mod:`.rules`) — stdlib-``ast`` source rules ``RPR0xx``:
    host-sync primitives on the per-chunk path (the ``HOT`` table), library
    sync seams outside the allowlist, raw wall-clock timing outside
    ``obs``, kernel wrappers that choose their plain version by anything
    but the device, cache sizes and CUDA-graph key fields.
  * Layer 2 (:mod:`.dispatch`) — ``TorchDispatchMode`` contract checks
    ``RPR1xx`` over the entry points: no float64 promotion, no host sync
    (the card's sync-debug mode), the declared hand-kernel counts and the
    live-run stats, combinadics rank capacity. Runs on the CPU or the card.
  * Layer 3 (:mod:`.cuda`) — the kernels on the card ``RPR2xx``: output
    coverage under a poisoned allocator, repeatability, and the ptxas
    resource report. Needs the card.

Plus an advisory import-graph orphan report (:mod:`.imports`). Nothing
here imports ``jax`` or the JAX package.
"""
from __future__ import annotations

from .baseline import BASELINE_NAME, BaselineEntry, compare
from .baseline import load as load_baseline
from .baseline import write as write_baseline
from .findings import RULE_CATALOG, Finding, Report, register_rule
from .rules import ALLOWLIST, HOT, check_tree

__all__ = [
    "Finding", "Report", "RULE_CATALOG", "register_rule",
    "BaselineEntry", "BASELINE_NAME", "load_baseline", "write_baseline",
    "compare", "check_tree", "ALLOWLIST", "HOT", "run_all",
]


def run_all(repo_root: str = ".", *, layers: tuple[int, ...] = (1, 2, 3),
            device=None) -> Report:
    """Run the requested layers and the advisory orphan report. Layer 1 is
    pure source analysis; layers 2 and 3 run entry points on ``device``
    (None means the CUDA card, as every entry point of the port; Layer 3
    raises without one)."""
    rep = Report()
    if 1 in layers:
        rep.extend(check_tree(repo_root))
    if 2 in layers or 3 in layers:
        from ..device import resolve_device

        dev = resolve_device(device)
        if 2 in layers:
            from . import dispatch

            fs, tables = dispatch.all_findings(dev)
            rep.extend(fs)
            rep.tables.update(tables)
        if 3 in layers:
            from . import cuda

            fs, tables = cuda.all_findings(dev)
            rep.extend(fs)
            rep.tables.update(tables)
    from . import imports

    rep.advisories.extend(imports.report(repo_root))
    return rep
