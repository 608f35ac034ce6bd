"""Layer 2 — dispatch-mode contract analyzers (``RPR1xx``).

The counterpart of ``src/repro/analysis/jaxpr.py``. torch has no jaxpr to
walk, so each entry point runs once on small shape-representative inputs
under a :class:`Recorder`, a ``TorchDispatchMode`` that sees every aten op
the entry dispatches, with the Python frames that issued it:

  RPR101  float64 promotion: any float64 output of an op inside an entry
          point (integer widening to int64 is the wide-rank regime and is
          allowed).
  RPR102  host syncs inside an entry point. On the CPU the recorder counts
          ``aten._local_scalar_dense`` (``int()``, ``bool()``, ``.item()``),
          ``nonzero``, ``equal``, a boolean-mask index and the like
          (``.tolist()`` dispatches no op: Layer 1 covers it); on the card
          the entry runs under ``torch.cuda.set_sync_debug_mode("warn")``
          and each warning is one sync. A sync inside an allowlisted seam
          (``rules.ALLOWLIST``) is counted, not reported. RPR102 also
          proves ``rules.HOT`` complete: a port function that runs an op
          below the entry's root (its per-chunk path) and is not in the
          table is a finding.
  RPR103  dispatch contract: (a) each entry's hand-kernel count against
          the port's declared table (:func:`entry_points`), row by row
          beside the reference's ``pallas_call`` count; (b) the live-run
          stats of "S", "E", "S-kernel" and "S-grid" obey the planner
          arithmetic, ``chunks == ceil(total / n_chunk)`` and
          ``dispatches == chunks × (1 | 2)``; on the card a recorded
          ``pc_scan`` program's kernel nodes equal its counted launches.
  RPR104  combinadics rank capacity over ``levels.plan_level`` and
          ``levels._check_rank_capacity``, for int32 and int64 ranks.

Counting hand kernels. On the card it is the ``build.LAUNCHES`` delta of
one steady call (after a warm call that builds the library and fills the
caches). On the CPU each kernel wrapper's plain version, reached through
the wrapper, is an opaque node: counted once and run outside the recorder,
so its deliberate float64 (cholinv's FMA emulation, sgrid's rsqrt, corr's
float64 accumulation) and its host work count against no rule — the
counterpart of ``pallas_call`` as one primitive.

The analyzers take injectable functions so the tests can aim them at
deliberately broken fixtures.
"""
from __future__ import annotations

import contextlib
import functools
import sys
import warnings
from collections import Counter
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from . import rules as R
from .findings import Finding, register_rule

RPR101 = register_rule("RPR101", "float64 output of an op inside an entry point")
RPR102 = register_rule(
    "RPR102", "host sync inside an entry point, or its per-chunk path outside rules.HOT")
RPR103 = register_rule(
    "RPR103", "hand-kernel count or live-run stats break the declared dispatch contract")
RPR104 = register_rule("RPR104", "combinadics commit keys exceed rank-dtype capacity")

PKG_ROOT = Path(__file__).resolve().parent.parent
ANALYSIS_DIR = Path(__file__).resolve().parent
K, C, B = (f"{R.PACKAGE_DIR}/{d}" for d in ("kernels", "core", "batch"))

#: aten ops that wait for the device (on the CPU: that read a tensor's
#: value into the host program)
SYNC_OPS = frozenset({
    "_local_scalar_dense", "nonzero", "equal", "is_nonzero", "masked_select", "_unique",
    "_unique2", "unique_dim", "unique_consecutive", "unique_dim_consecutive", "argwhere",
})
#: kernel wrapper (``module::function``) → its plain version (module
#: attribute) and the ``build.LAUNCHES`` name it stands for
PLAIN_VERSIONS = {
    ("corr", "corr_matmul_plain"): ("corr", ("kernels/corr.py::corr_matmul",)),
    ("level1", "level1_dense_plain"): ("level1", ("kernels/level1.py::level1_dense_kernel",)),
    ("cholinv", "cholinv_plain"): ("cholinv", ("kernels/cholinv.py::cholinv",)),
    ("cisweep", "cisweep_plain"): ("cisweep", ("kernels/cisweep.py::cisweep",)),
    ("gsq", "gsq_ref"): ("gsq", ("kernels/ops.py::gsq",)),
    ("sgrid", "sgrid_plain"): ("sgrid", ("kernels/sgrid.py::sgrid",
                                         "kernels/sgrid.py::sgrid_fused")),
    ("skernel", "skernel_plain"): ("skernel", ("kernels/skernel.py::skernel_fused",)),
}


# ------------------------------------------------------------------- frames
@functools.lru_cache(maxsize=256)
def _port_rel(filename: str) -> str | None:
    """``filename`` relative to the package, None outside it or inside
    this suite."""
    try:
        p = Path(filename).resolve()
    except (OSError, ValueError):
        return None
    if not p.is_relative_to(PKG_ROOT) or p.is_relative_to(ANALYSIS_DIR):
        return None
    return p.relative_to(PKG_ROOT).as_posix()


def port_frames(frame) -> list[tuple[str, str, int]]:
    """(module, function, line) of every port frame from ``frame``
    outward, innermost first; lambdas and generator expressions are parts
    of their enclosing function."""
    out = []
    while frame is not None:
        rel = _port_rel(frame.f_code.co_filename)
        if rel is not None and not frame.f_code.co_name.startswith("<"):
            out.append((rel, frame.f_code.co_name, frame.f_lineno))
        frame = frame.f_back
    return out


def _origin(frame) -> tuple[str, str, int]:
    """Where an op was issued: the innermost port frame, else the innermost
    frame outside this suite and the ``warnings`` machinery (module
    ``<outside:file>``), so that no sync goes unattributed."""
    frames = port_frames(frame)
    if frames:
        return frames[0]
    while frame is not None:
        name = frame.f_code.co_filename
        if not (name.endswith("warnings.py") or Path(name).resolve().is_relative_to(
                ANALYSIS_DIR)):
            return (f"<outside:{Path(name).name}>", frame.f_code.co_name, frame.f_lineno)
        frame = frame.f_back
    return ("<outside>", "?", 0)


def _sync_kind(name: str, args, kwargs) -> str | None:
    if name in SYNC_OPS:
        return name
    if name == "repeat_interleave" and args and isinstance(args[-1], torch.Tensor) \
            and kwargs.get("output_size") is None:
        return name
    if name in ("index", "index_put", "index_put_", "_index_put_impl_") and len(args) > 1:
        idx = [t for t in (args[1] or ()) if isinstance(t, torch.Tensor)]
        if any(t.dtype in (torch.bool, torch.uint8) for t in idx):
            return f"{name}(mask)"
    return None


class Recorder(TorchDispatchMode):
    """Every aten op an entry dispatches: the float64 outputs, the host
    syncs (``count_syncs``: op-based, the CPU's means) with the port
    function that issued each, the port functions that ran ops below
    ``root`` (``module::function``, the entry's per-chunk path), and the
    opaque plain-version nodes by kernel name."""

    def __init__(self, root: str | None = None, count_syncs: bool = True):
        super().__init__()
        self.root = root
        self.count_syncs = count_syncs
        self.ops = 0
        self.f64: list[tuple[str, str]] = []
        self.syncs: list[tuple[str, tuple]] = []
        self.path_fns: set[str] = set()
        self.opaque: Counter = Counter()
        self.paused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.paused:
            return out
        self.ops += 1
        name = func.overloadpacket.__name__
        frames = port_frames(sys._getframe(1))
        if self.count_syncs:
            kind = _sync_kind(name, args, kwargs)
            if kind:
                self.syncs.append((kind, frames[0] if frames else _origin(sys._getframe(1))))
        if any(isinstance(t, torch.Tensor) and t.dtype == torch.float64
               for t in tree_leaves(out)):
            self.f64.append((name, "::".join(map(str, frames[0][:2])) if frames else "?"))
        if self.root is not None:
            keys = [f"{m}::{f}" for m, f, _ in frames]
            if self.root in keys:
                self.path_fns.update(keys[: keys.index(self.root) + 1])
        return out


@contextlib.contextmanager
def opaque_plain_versions(rec: Recorder):
    """Patch each kernel module's plain version so that, reached through
    its wrapper, it counts one node under the kernel's name and runs with
    ``rec`` paused (called directly — the "G2" engine's ``gsq_ref`` — it is
    an ordinary traced function)."""
    import importlib

    saved = []
    for (mod_name, attr), (kernel, sites) in PLAIN_VERSIONS.items():
        mod = importlib.import_module(f"repro_torch.kernels.{mod_name}")
        real = getattr(mod, attr)

        def opaque(*a, _real=real, _kernel=kernel, _sites=sites, **kw):
            caller = sys._getframe(1)
            site = f"{_port_rel(caller.f_code.co_filename)}::{caller.f_code.co_name}"
            if site not in _sites or rec.paused:
                return _real(*a, **kw)
            rec.opaque[_kernel] += 1
            rec.paused += 1
            try:
                return _real(*a, **kw)
            finally:
                rec.paused -= 1

        functools.update_wrapper(opaque, real)
        saved.append((mod, attr, real))
        setattr(mod, attr, opaque)
    try:
        yield rec
    finally:
        for mod, attr, real in saved:
            setattr(mod, attr, real)


@contextlib.contextmanager
def sync_warnings(out: list):
    """Run under ``torch.cuda.set_sync_debug_mode("warn")``; append the
    innermost port frame (module, function, line) of each synchronizing
    CUDA operation to ``out``."""
    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            out.append(_origin(sys._getframe(1)))

    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("warn")  # the setters stay outside the hook
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = hook
            yield out
    finally:
        torch.cuda.set_sync_debug_mode(prev)


# ------------------------------------------------------------------ RPR101/2
def promotion_findings(rec: Recorder, name: str, path: str) -> list[Finding]:
    if not rec.f64:
        return []
    ops = sorted({op for op, _ in rec.f64})
    where = sorted({w for _, w in rec.f64})
    return [Finding(
        code=RPR101, path=path, line=0,
        message=f"`{name}` produces float64 at {len(rec.f64)} op(s) ({', '.join(ops[:6])}; "
                f"in {', '.join(where[:4])}) — the bit-parity contract requires the fp32 "
                "pipeline end to end",
        context=name, detail="f64-promotion",
    )]


def sync_findings(syncs, name: str, allowlist: dict[str, str] | None = None):
    """(findings, seams): each sync ``(kind, (module, function, line))``
    outside an allowlisted seam is a finding; ``seams`` counts the rest."""
    seams = R.seam_functions(allowlist)
    out, seen, n_seam = [], set(), 0
    for kind, (mod, fn, line) in syncs:
        path = mod if mod.startswith("<") else f"{R.PACKAGE_DIR}/{mod}"
        if f"{path}::{fn}" in seams:
            n_seam += 1
            continue
        f = Finding(code=RPR102, path=path, line=line,
                    message=f"`{name}` syncs with the host: `{kind}` in `{fn}` — the entry's "
                            "path must stay asynchronous, or the seam be named in "
                            "rules.ALLOWLIST",
                    context=name, detail=f"{kind}@{fn}")
        if f.key not in seen:
            seen.add(f.key)
            out.append(f)
    return out, n_seam


def completeness_findings(path_fns, name: str, path: str,
                          hot: frozenset[str] | None = None) -> list[Finding]:
    hot = R.HOT if hot is None else hot
    return [Finding(code=RPR102, path=path, line=0,
                    message=f"`{name}` runs `{fn}` on its per-chunk path, which is not in "
                            "rules.HOT — Layer 1 does not check it for host syncs",
                    context=name, detail=f"unlisted:{fn}")
            for fn in sorted(set(path_fns) - set(hot))]


# -------------------------------------------------------------------- RPR103
def kernel_count_findings(got: int, expected: int, name: str, path: str,
                          device: str = "cpu") -> list[Finding]:
    if got != expected:
        return [Finding(
            code=RPR103, path=path, line=0,
            message=f"`{name}` ran {got} hand kernel(s) on {device}; the declared dispatch "
                    f"contract is {expected} — a hidden kernel launch changes the per-level "
                    "dispatch count",
            context=name, detail=f"kernels:{device}:{got}!={expected}",
        )]
    return []


def stats_contract_findings(level_stats, path: str = "<run>") -> list[Finding]:
    """A live run's per-level stats against the planner arithmetic:
    ``chunks == ceil(total_sets/n_chunk)`` and ``dispatches == chunks ×
    (2 if pipelined else 1)``. ``level_stats``: iterable of stats dicts
    (``PCRun.level_stats``)."""
    out = []
    for i, st in enumerate(level_stats):
        if not isinstance(st, dict) or st.get("skipped", False):
            continue
        ctx = f"level[{i}]:{st.get('engine', '?')}"
        total, n_chunk = st.get("total_sets"), st.get("n_chunk")
        chunks, disp = st.get("chunks"), st.get("dispatches")
        if total is not None and n_chunk:
            want_chunks = -(-total // n_chunk)
            if chunks != want_chunks:
                out.append(Finding(
                    code=RPR103, path=path, line=0,
                    message=f"{ctx}: {chunks} chunks for {total} sets at n_chunk={n_chunk} "
                            f"(expected {want_chunks})",
                    context=ctx, detail="chunks",
                ))
        if chunks is not None and disp is not None:
            mult = 2 if st.get("pipeline_depth", 1) > 1 else 1
            if disp != chunks * mult:
                out.append(Finding(
                    code=RPR103, path=path, line=0,
                    message=f"{ctx}: dispatches={disp} but chunks={chunks} with pipeline "
                            f"multiplier {mult} — the stats['dispatches'] contract is broken",
                    context=ctx, detail="dispatches",
                ))
    return out


def census_findings(census: dict, counted: dict, name: str, path: str) -> list[Finding]:
    """A recorded program's hand kernels among its graphs' kernel nodes
    (``cuda.graph_kernels``) against the launches its capture counted."""
    counted = {k: v for k, v in counted.items() if v}
    if census != counted:
        return [Finding(code=RPR103, path=path, line=0,
                        message=f"`{name}`'s graphs hold the hand kernels {census}, not the "
                                f"counted {counted}",
                        context=name, detail="graph-census")]
    return []


# -------------------------------------------------------------------- RPR104
def rank_capacity_findings(plan_fn=None, imax: int | None = None, n_max: int = 96,
                           l_max: int = 8, rank_dtype: torch.dtype = torch.int32,
                           path: str = f"{C}/levels.py") -> list[Finding]:
    """Exhaustively sweep (n′, ℓ) and assert: every plan the planner RETURNS
    keeps (a) the worst commit key ``(total−1)·2+1`` strictly under the
    ``imax`` sentinel (``levels._global_commit`` decides removals with
    ``key < imax``, so a key ≥ imax silently drops a real winner) and (b)
    every rank a chunk touches (< total + n_chunk) exact in the clipped
    binomial table. Plans the planner refuses (ValueError) are safe."""
    from repro_torch.core import levels as L

    plan_fn = plan_fn or functools.partial(L.plan_level, rank_dtype=rank_dtype)
    imax = int(L._imax(rank_dtype)) if imax is None else int(imax)
    out = []
    for npr in range(2, n_max + 1):
        for ell in range(1, min(npr, l_max) + 1):
            try:
                _, n_chunk, total = plan_fn(npr, ell, n_rows=8)
            except ValueError:
                continue  # loud refusal — the guard did its job
            worst_key = (total - 1) * 2 + 1
            if worst_key >= imax:
                out.append(Finding(
                    code=RPR104, path=path, line=0,
                    message=f"plan_level({npr}, {ell}) accepts total={total} but the worst "
                            f"commit key {worst_key} reaches the imax sentinel {imax} — "
                            "winners with rank ≥ imax/2 would silently fail to commit",
                    context="plan_level", detail=f"key-overflow:{npr},{ell}",
                ))
                continue
            if n_chunk > 1 and total + n_chunk > imax:
                out.append(Finding(
                    code=RPR104, path=path, line=0,
                    message=f"plan_level({npr}, {ell}) chunk reaches rank {total + n_chunk} "
                            f"past the clipped binomial table capacity {imax}",
                    context="plan_level", detail=f"table-overflow:{npr},{ell}",
                ))
    return out


def guard_findings(check_fn=None, rank_dtype: torch.dtype = torch.int32,
                   path: str = f"{C}/levels.py") -> list[Finding]:
    """``levels._check_rank_capacity`` at the edge of the capacity: a total
    above imax // 2 must be refused, and an accepted chunk must keep every
    rank it touches (< total + n_chunk) within imax."""
    from repro_torch.core import levels as L

    check_fn = check_fn or L._check_rank_capacity
    big = int(L._imax(rank_dtype))
    name = str(rank_dtype).removeprefix("torch.")
    out = []
    for total in (big // 2 - 1, big // 2, big // 2 + 1):
        for n_chunk in (1, 64, 1 << 20):
            try:
                got = check_fn(total, n_chunk, 2, rank_dtype)
            except ValueError:
                if total <= big // 2:
                    out.append(Finding(
                        code=RPR104, path=path, line=0,
                        message=f"_check_rank_capacity refuses {total} sets ({name}), within "
                                f"the capacity {big // 2}",
                        context="_check_rank_capacity", detail=f"refused:{name}:{total}"))
                continue
            if total > big // 2 or (got > 1 and total + got > big):
                out.append(Finding(
                    code=RPR104, path=path, line=0,
                    message=f"_check_rank_capacity accepts {total} sets at n_chunk={got} "
                            f"({name}): keys or ranks pass the {big} sentinel",
                    context="_check_rank_capacity", detail=f"accepted:{name}:{total},{got}"))
    return out


# ------------------------------------------------------- entry-point registry
@dataclass(frozen=True)
class Entry:
    name: str
    build: Callable  # (device) -> (fn, args tuple, kwargs dict)
    cpu: int  # hand kernels on the CPU: opaque plain-version nodes
    cuda: int  # hand kernels on the card: the build.LAUNCHES delta of a steady call
    reference: int | None  # the reference's pallas_call count (jaxpr.py), None: no row
    path: str
    root: str  # module::function where the entry's per-chunk path starts
    engines: tuple = ()  # core/engines.py names this entry carries
    why: str = ""  # where the counts differ from the reference's, the reason


def _gauss_chunk_args(dev, n=16, npr=8, ell=2, n_chunk=8):
    """C, a random adjacency of degree ≤ n′, its width-n′ compaction, the
    level-0 sepsets and the first rank: a chunk of every row at ℓ."""
    import numpy as np

    from repro_torch.core.compact import compact_rows

    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, n)) + rng.normal(size=(64, 1))
    c = torch.tensor(np.corrcoef(x, rowvar=False), dtype=torch.float32, device=dev)
    a = np.triu(rng.random((n, n)) < 0.45, 1)
    adj = torch.tensor(a | a.T, device=dev)
    compact, counts = compact_rows(adj, n_prime=npr)
    counts = counts.clamp(max=npr)
    sep = torch.full((n, n, 8), -1, dtype=torch.int32, device=dev)
    t0 = torch.zeros((), dtype=torch.int32, device=dev)
    kw = dict(ell=ell, n_chunk=n_chunk, n_max=npr)
    return c, adj, sep, compact, counts, t0, 0.05, kw


def _ops():
    from repro_torch.kernels import ops

    return ops


def entry_points() -> list[Entry]:
    """The per-chunk surface the parity matrix rests on, with each entry's
    declared hand-kernel counts on the CPU and on the card beside the
    reference's ``pallas_call`` count (``src/repro/analysis/jaxpr.py``'s
    ``entry_points``). Adding an engine means adding a row here (a test
    holds the registry to ``engines.ENGINE_NAMES``)."""
    from repro_torch.core import levels as L

    def chunk(fn_of, drop_sep=False):
        def build(dev):
            c, adj, sep, compact, counts, t0, tau, kw = _gauss_chunk_args(dev)
            args = (c, adj, compact, counts, t0, tau) if drop_sep else (
                c, adj, sep, compact, counts, t0, tau)
            return fn_of(), args, kw
        return build

    def rows_entry(fn_name):
        def build(dev):
            c, adj, sep, compact, counts, t0, tau, kw = _gauss_chunk_args(dev)
            rows = torch.arange(compact.shape[0], dtype=torch.int32, device=dev)
            if fn_name == "chunk_s_grid_tests_cols":
                col_pos = torch.arange(c.shape[0], device=dev)
                return (_ops().chunk_s_grid_tests_cols,
                        (c, c, col_pos, adj, compact, counts, rows, t0, tau), kw)
            return _ops().chunk_s_grid_tests, (c, adj, compact, counts, rows, t0, tau), kw
        return build

    def g2(kernel):
        def build(dev):
            from repro_torch.core.cit import DiscreteStats
            from repro_torch.kernels.gsq import gsq_ref

            _, adj, sep, compact, counts, t0, _, kw = _gauss_chunk_args(dev)
            gen = torch.Generator().manual_seed(0)
            stats = DiscreteStats(codes=torch.randint(0, 2, (32, 16), generator=gen,
                                                      dtype=torch.int32).to(dev),
                                  arities=torch.full((16,), 2, dtype=torch.int32, device=dev))
            kw = dict(kw, r=2, gsq_fn=_ops().gsq if kernel else gsq_ref)
            return L.chunk_g2, (stats, adj, sep, compact, counts, t0, 0.01), kw
        return build

    def level1_dense(dev):
        c, adj, *_ = _gauss_chunk_args(dev, n=64)
        return _ops().level1_dense, (c, adj, 0.05), {}

    def level0(dev):
        c, *_ = _gauss_chunk_args(dev, n=64)
        return _ops().level0, (c, 0.05), {}

    def level0_span(dev):
        c, *_ = _gauss_chunk_args(dev, n=64)
        return _ops().level0_span, (c, 0.05, 8), {}

    def correlation(m):
        def build(dev):
            gen = torch.Generator().manual_seed(0)
            return _ops().correlation, (torch.randn((m, 64), generator=gen).to(dev),), {}
        return build

    def gsq(dev):
        gen = torch.Generator().manual_seed(0)
        return _ops().gsq, (torch.randint(0, 8, (64, 32), generator=gen,
                                          dtype=torch.int32).to(dev),), dict(r=2, q=2)

    def gathered(grid):
        def build(dev):
            c, adj, sep, compact, counts, t0, tau, kw = _gauss_chunk_args(dev)
            rows = torch.arange(compact.shape[0], dtype=torch.int32, device=dev)
            ranks = L._chunk_ranks(t0, kw["n_chunk"])
            m2, ci_s, cj_s, cij, mask, s_ids = L.gather_s(c, adj, compact, counts, rows, ranks,
                                                          ell=kw["ell"], n_max=kw["n_max"])
            if grid:
                return (_ops().ci_shared_grid, (m2, ci_s, cj_s, cij, mask, s_ids, tau),
                        dict(ell=kw["ell"]))
            n_l, t_len, npr = mask.shape
            b = n_l * t_len
            ell = kw["ell"]
            return (_ops().ci_shared,
                    (m2.reshape(b, ell, ell), ci_s.reshape(b, ell),
                     cj_s.reshape(b, npr, ell), cij.reshape(b, npr), mask.reshape(b, npr), tau),
                    dict(ell=ell))
        return build

    def pc_scan(dev):
        from repro_torch.batch.scan_pc import pc_scan as fn

        c, *_ = _gauss_chunk_args(dev)

        def run(c, taus):
            return fn(c, m=200, max_level=2, n_prime=4, taus=taus, device=c.device)

        return run, (c, (0.5, 0.4, 0.3)), {}

    def lm(step, arch="qwen3-1.7b"):
        def build(dev):
            from repro_torch.configs import ARCHS
            from repro_torch.models import registry

            cfg = ARCHS[arch].reduced()
            api = registry.build(cfg, compute_dtype=torch.float32, device=dev)
            params = api.init()
            gen = torch.Generator(dev).manual_seed(1)
            tokens = torch.randint(0, cfg.vocab, (2, 8), generator=gen, device=dev,
                                   dtype=torch.int32)
            if step == "prefill":
                return api.prefill, (params, {"tokens": tokens}, 16), {}
            _, cache = api.prefill(params, {"tokens": tokens}, 16)
            return api.decode, (params, {"tokens": tokens[:, :1]}, cache), {}
        return build

    def whisper(step):
        def build(dev):
            from repro_torch.configs import ARCHS
            from repro_torch.models import registry

            cfg = ARCHS["whisper-large-v3"].reduced()
            api = registry.build(cfg, compute_dtype=torch.float32, device=dev)
            params = api.init()
            gen = torch.Generator(dev).manual_seed(1)
            batch = {"tokens": torch.randint(0, cfg.vocab, (2, 8), generator=gen, device=dev,
                                             dtype=torch.int32),
                     "frames": torch.randn((2, cfg.enc_ctx, cfg.d_model), generator=gen,
                                           device=dev) * 0.1}
            if step == "prefill":
                return api.prefill, (params, batch, 16), {}
            _, cache = api.prefill(params, batch, 16)
            return api.decode, (params, {"tokens": batch["tokens"][:, :1]}, cache), {}
        return build

    def train(arch):
        def build(dev):
            from repro_torch.configs import ARCHS, TrainConfig
            from repro_torch.models import registry
            from repro_torch.optim import adamw_init

            cfg = ARCHS[arch].reduced()
            params = registry.build(cfg, compute_dtype=torch.float32, device=dev).init()
            step = registry.make_train_step(cfg, TrainConfig(compute_dtype="float32"),
                                            device=dev)
            gen = torch.Generator(dev).manual_seed(1)
            toks = torch.randint(0, cfg.vocab, (2, 9), generator=gen, device=dev,
                                 dtype=torch.int32)
            batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
            return step, (params, adamw_init(params), batch), {}
        return build

    ops_p, lv = f"{K}/ops.py", f"{C}/levels.py"
    lm_p, lm_root = f"{R.PACKAGE_DIR}/models/transformer.py", "models/transformer.py::{}".format
    lm_why = ("the LM serving path (reduced {}, fp32) holds no hand kernel, and the "
              "reference's traced prefill and decode hold no pallas_call (0); the reference's "
              "jaxpr table has no LM row").format
    #: one prefill and one decode row a segment-kind family beyond attn_mlp
    families = {"moe": "qwen2-moe-a2.7b", "mla": "deepseek-v2-236b", "rwkv6": "rwkv6-3b",
                "zamba2": "zamba2-1.2b"}
    chunk_root = "core/levels.py::{}".format
    ops_root = "kernels/ops.py::{}".format
    return [
        Entry("chunk_s", chunk(lambda: L.chunk_s), 0, 0, 0, lv, chunk_root("chunk_s"), ("S",)),
        Entry("chunk_e", chunk(lambda: L.chunk_e), 0, 0, 0, lv, chunk_root("chunk_e"), ("E",)),
        Entry("chunk_s_tests", chunk(lambda: L.chunk_s_tests, drop_sep=True), 0, 0, 0, lv,
              chunk_root("chunk_s_tests"), ("S",)),
        Entry("chunk_g2", g2(False), 0, 0, 0, lv, chunk_root("chunk_g2"), ("G2",)),
        Entry("chunk_g2_kernel", g2(True), 1, 1, 1, lv, chunk_root("chunk_g2"),
              ("G2-kernel",)),
        Entry("chunk_s_kernel", chunk(lambda: _ops().chunk_s_kernel), 1, 1, 2, ops_p,
              ops_root("chunk_s_kernel"), ("S-kernel", "auto"),
              "one fused skernel launch a chunk (cholinv and cisweep in one kernel, no "
              "gather) against the reference's two pallas_calls"),
        Entry("chunk_s_two_launch", chunk(lambda: _ops().chunk_s_two_launch), 2, 2, None,
              ops_p, ops_root("chunk_s_two_launch"), (),
              "the reference's two-kernel chunk kept as a chunk_fn_s hook: its 2"),
        Entry("chunk_s_grid", chunk(lambda: _ops().chunk_s_grid), 1, 1, 1, ops_p,
              ops_root("chunk_s_grid"), ("S-grid",)),
        Entry("chunk_s_grid_tests", rows_entry("chunk_s_grid_tests"), 1, 1, None, ops_p,
              ops_root("chunk_s_grid_tests"), ("S-grid",),
              "the sharded grid engine's tests half (replicated C): one fused sgrid launch"),
        Entry("chunk_s_grid_tests_cols", rows_entry("chunk_s_grid_tests_cols"), 1, 1, None,
              ops_p, ops_root("chunk_s_grid_tests_cols"), ("S-grid",),
              "the sharded-C route: gather_s_cols and sgrid's gathered entry"),
        Entry("level1_dense", level1_dense, 1, 1, 1, ops_p, ops_root("level1_dense"),
              ("L1-dense", "auto")),
        Entry("level0", level0, 0, 1, 1, ops_p, ops_root("level0"), (),
              "on the CPU ops.level0 takes levels.level0, the level loop's own ops, traced "
              "op by op (no opaque plain version); one level0 launch on the card"),
        Entry("level0_span", level0_span, 0, 1, None, ops_p, ops_root("level0_span"),
              ("S", "E", "S-kernel", "S-grid", "L1-dense", "auto"),
              "the driver's fused level-0 span: levels.level0_span's ops on the CPU, one "
              "level0 launch on the card"),
        Entry("correlation", correlation(256), 1, 1, 1, ops_p, ops_root("correlation"), ()),
        Entry("correlation_split_k", correlation(1024), 1, 2, 1, ops_p,
              ops_root("correlation"), (),
              "m > 512 takes corr's split-K path: the splits and their reduction, two "
              "launches under build.LAUNCHES"),
        Entry("gsq", gsq, 1, 1, 1, ops_p, ops_root("gsq"), ("G2-kernel",),
              "the reference's gsq_cells row; ops.gsq picks the kernel or gsq_ref"),
        Entry("ci_shared", gathered(False), 2, 2, None, ops_p, ops_root("ci_shared"), (),
              "the gathered cholinv and cisweep: two launches"),
        Entry("ci_shared_grid", gathered(True), 1, 1, None, ops_p, ops_root("ci_shared_grid"),
              (), "sgrid's gathered entry"),
        Entry("pc_scan", pc_scan, 0, 3, 0, f"{B}/scan_pc.py", "batch/scan_pc.py::_scan_core",
              ("scan",),
              "on the card the recorded program replays the fused level-0 span (1) and one "
              "skernel launch a sweep step (1 step at each of ℓ = 1, 2); on the CPU the scan "
              "runs levels.chunk_s, as the reference's scan traces no pallas_call"),
        Entry("lm_prefill", lm("prefill"), 0, 0, None, lm_p, lm_root("lm_prefill"), (),
              lm_why("qwen3-1.7b")),
        Entry("lm_decode", lm("decode"), 0, 0, None, lm_p, lm_root("lm_decode_step"), (),
              lm_why("qwen3-1.7b")),
    ] + [Entry(f"lm_{step}_{fam}", lm(step, arch), 0, 0, None, lm_p, lm_root(root), (),
               lm_why(arch))
         for fam, arch in families.items()
         for step, root in (("prefill", "lm_prefill"), ("decode", "lm_decode_step"))] + [
        Entry(f"whisper_{step}", whisper(step), 0, 0, None, f"{R.PACKAGE_DIR}/models/whisper.py",
              f"models/whisper.py::{root}", (),
              "Whisper's serving path (reduced whisper-large-v3, fp32) holds no hand kernel; "
              "the reference's whisper_prefill and whisper_decode_step hold no pallas_call (0)")
        for step, root in (("prefill", "whisper_prefill"), ("decode", "whisper_decode_step"))
    ] + [
        Entry(name, train(arch), 0, 0, None, f"{R.PACKAGE_DIR}/models/registry.py",
              "models/registry.py::train_step", (),
              f"one train step of reduced {arch} (loss, the flash and CE backward, the clip, "
              "AdamW) holds no hand kernel; the reference's train step holds no pallas_call "
              "(0)")
        for name, arch in (("lm_train_step", "qwen3-1.7b"),
                           ("lm_train_step_moe", "qwen2-moe-a2.7b"))]


def run_entry(e: Entry, device: torch.device, allowlist=None, hot=None) -> tuple[list, dict]:
    """One entry on ``device``: (findings, row). The row holds the counts
    and syncs phase 9 of chip_smoke.py prints."""
    from repro_torch.kernels import build

    cuda = device.type == "cuda"
    fn, args, kwargs = e.build(device)
    if cuda:  # a warm call: the library, the binomial tables, a recording
        fn(*args, **kwargs)
        torch.cuda.synchronize(device)
    warned: list = []
    build.reset_launches()
    rec = Recorder(root=e.root, count_syncs=not cuda)
    with contextlib.ExitStack() as stack:
        if cuda:
            stack.enter_context(sync_warnings(warned))
        stack.enter_context(opaque_plain_versions(rec))
        stack.enter_context(rec)
        fn(*args, **kwargs)
    if cuda:
        torch.cuda.synchronize(device)
        got = sum(build.LAUNCHES.values())
        syncs = [("sync-debug", w) for w in warned]
    else:
        got = sum(rec.opaque.values())
        syncs = rec.syncs
    want = e.cuda if cuda else e.cpu
    out = promotion_findings(rec, e.name, e.path)
    sync_fs, n_seams = sync_findings(syncs, e.name, allowlist)
    out += sync_fs
    out += completeness_findings(rec.path_fns, e.name, e.path, hot)
    out += kernel_count_findings(got, want, e.name, e.path, device.type)
    row = dict(name=e.name, device=device.type, kernels=got, declared=want,
               reference=e.reference, launches=(dict(build.LAUNCHES) if cuda
                                                else dict(rec.opaque)),
               syncs=len(sync_fs), seam_syncs=n_seams,
               all_syncs=len(syncs), f64_ops=len(rec.f64), ops=rec.ops, why=e.why)
    if cuda and e.name == "pc_scan":
        out += _scan_census(e)
    return out, row


def _scan_census(e: Entry) -> list[Finding]:
    from repro_torch.batch import capture

    from .cuda import graph_kernels

    progs = [p for p in capture.programs() if p.key[0] == "pc_scan"]
    if not progs:
        return [Finding(code=RPR103, path=e.path, line=0, context=e.name,
                        message="no recorded pc_scan program to take a census of",
                        detail="graph-census")]
    census, _ = graph_kernels(progs[-1])
    return census_findings(census, progs[-1].launches, e.name, e.path)


def check_entry_points(device, entries: list[Entry] | None = None):
    """RPR101 + RPR102 + RPR103(a) over the registered entry points:
    (findings, rows)."""
    out, rows = [], []
    for e in (entries if entries is not None else entry_points()):
        fs, row = run_entry(e, device)
        out += fs
        rows.append(row)
    return out, rows


def check_dispatch_contract(device, engines=("S", "E", "S-kernel", "S-grid"), n: int = 24,
                            m: int = 400, cell_budget: int = 16384):
    """RPR103(b): each engine (and "S" pipelined at depth 2) on a small
    concrete workload, at a cell budget that splits every level into
    several chunks, its published level stats against the planner
    arithmetic. On the card the second of two runs (the first fills the
    caches) also counts its syncs, held to the allowlisted seams (RPR102):
    a sync a chunk would show here. Returns (findings, rows)."""
    import numpy as np

    from repro_torch.core.pc import pc_from_corr

    rng = np.random.default_rng(0)
    x = rng.normal(size=(m, n)) + rng.normal(size=(m, 1)) * 0.7
    c = torch.tensor(np.corrcoef(x, rowvar=False), dtype=torch.float32, device=device)
    cuda = device.type == "cuda"
    out, rows = [], []
    runs = [(eng, 1) for eng in engines] + [("S", 2)]
    for eng, depth in runs:
        label = f"pc_from_corr engine={eng}" + (f" pipeline_depth={depth}" if depth > 1 else "")
        kw = dict(alpha=0.05, engine=eng, max_level=2, device=device, validate=False,
                  pipeline_depth=depth, cell_budget=cell_budget)
        warned: list = []
        if cuda:
            pc_from_corr(c, m, **kw)
            torch.cuda.synchronize(device)
            with sync_warnings(warned):
                run = pc_from_corr(c, m, **kw)
        else:
            run = pc_from_corr(c, m, **kw)
        out += stats_contract_findings(run.level_stats, path=f"<{label}>")
        sync_fs, n_seams = sync_findings([("sync-debug", w) for w in warned], label)
        out += sync_fs
        rows.append(dict(name=label, levels=len(run.level_stats),
                         chunks=[st.get("chunks") for st in run.level_stats],
                         dispatches=[st.get("dispatches") for st in run.level_stats],
                         syncs=len(sync_fs), seam_syncs=n_seams))
    return out, rows


def all_findings(device):
    """Every Layer-2 check on ``device``: (findings, {table: rows})."""
    device = torch.device(device)
    out, entries = check_entry_points(device)
    fs, contract = check_dispatch_contract(device)
    out += fs
    for dt in (torch.int32, torch.int64):
        out += rank_capacity_findings(rank_dtype=dt)
        out += guard_findings(rank_dtype=dt)
    return out, {"entries": entries, "contract": contract}



__all__ = [
    "all_findings", "check_entry_points", "check_dispatch_contract", "run_entry",
    "stats_contract_findings", "rank_capacity_findings", "guard_findings",
    "kernel_count_findings", "promotion_findings", "sync_findings", "completeness_findings",
    "census_findings", "entry_points", "Entry", "Recorder", "opaque_plain_versions",
    "sync_warnings", "port_frames", "SYNC_OPS",
]

