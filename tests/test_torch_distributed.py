"""The port's multi-device layer (``repro_torch.core.distributed``) against
the JAX package, on the CPU with K logical shards (a mesh of K CPU
devices, the port's counterpart of the reference's forced host devices).

Fixtures are tests/test_distributed_pc.py's, (K, n, density, seed) =
(8, 30, 0.2, 4), (4, 24, 0.25, 1) and (8, 17, 0.3, 2): an uneven split,
an even one and heavy padding (n < 3K). The combinations are every layout
and engine of tests/test_sharding.py (the "S" flags of its shard_sep /
cache / pipeline test and the "S-grid" ones of its grid test).

* Results: ``pc_distributed`` fed the JAX package's C (``c=, m=``) is
  bitwise equal to the JAX single-device ``pc(x, engine="S")`` (run in
  the subprocesses below) in
  skeleton, sepsets and CPDAG (torch's and XLA's fp32 matmuls differ in
  the last bits, so C is carried across).
* Counters: the per-level stats (chunks, dispatches, widths, column
  gathers and their bytes, speculative hits, depth, engine) equal JAX
  ``pc_distributed``'s on the same K. The JAX runs are made in one
  subprocess a fixture with ``XLA_FLAGS=--xla_force_host_platform_device_count=K``
  (as tests/test_distributed_pc.py does), started together when the
  module loads. In them the grid engine's Pallas launch is replaced by
  its jnp twin (``levels._tests_s`` + ``_winners``, which the reference
  holds bitwise to it): interpret-mode sgrid would take minutes, and the
  counters depend only on the plan.
* Resume: a JAX per-level checkpoint, carried across by
  ``state.state_from_numpy``, resumes to the uninterrupted JAX result.

Tolerance: bitwise everywhere.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.cit import correlation_from_samples  # noqa: E402
from repro.data.synthetic_dag import sample_gaussian_dag  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import sharding as S  # noqa: E402
from repro_torch.core.distributed import pc_distributed  # noqa: E402
from repro_torch.state import state_from_numpy  # noqa: E402

pytestmark = [pytest.mark.torch, pytest.mark.distributed]

ROOT = Path(__file__).resolve().parents[1]
M = 2500
FIXTURES = [(8, 30, 0.2, 4), (4, 24, 0.25, 1), (8, 17, 0.3, 2)]
COMBOS = {
    "replicated": {},
    "shard_sep": dict(shard_sep=True),
    "shard_c+sep": dict(shard_c=True, shard_sep=True),
    "shard_c+sep+d3": dict(shard_c=True, shard_sep=True, pipeline_depth=3),
    "shard_c+nocache+d2": dict(shard_c=True, cache_cols=False, pipeline_depth=2),
    "shard_sep+d4": dict(shard_sep=True, pipeline_depth=4),
    "grid": dict(engine="S-grid"),
    "grid+c+sep+spec": dict(engine="S-grid", shard_c=True, shard_sep=True, speculate=True),
    "grid+sep+d3": dict(engine="S-grid", shard_sep=True, pipeline_depth=3),
    "grid+spec": dict(engine="S-grid", speculate=True),
    "grid+c": dict(engine="S-grid", shard_c=True),
}
STAT_KEYS = ("level", "skipped", "chunks", "dispatches", "npr_bucket", "n_chunk", "total_sets",
             "k_cols", "col_gathers", "col_gather_bytes", "speculative", "pipeline_depth",
             "engine")
RESUME = (4, 24, 0.25, 1)

_JAX_SCRIPT = textwrap.dedent("""
    import json, sys
    import numpy as np
    import jax.numpy as jnp
    from repro.core import levels as L
    from repro.core import sharding as SH
    from repro.core.distributed import pc_distributed
    from repro.core.pc import pc
    from repro.data.synthetic_dag import sample_gaussian_dag
    from repro.kernels import ops

    def grid_tests(c, adj, compact, counts, rows, t0, tau, *, ell, n_chunk, n_max):
        ranks = t0 + jnp.arange(n_chunk, dtype=L._rank_dtype())
        found, s_ids = L._tests_s(c, adj, compact, counts, rows, ranks, tau, ell=ell,
                                  n_max=n_max)
        return L._winners(found, ranks, s_ids, None)

    def grid_tests_cols(c_rows, c_cols, col_pos, adj, compact, counts, rows, t0, tau, *,
                        ell, n_chunk, n_max):
        ranks = t0 + jnp.arange(n_chunk, dtype=L._rank_dtype())
        found, s_ids = L._tests_s_cols(c_rows, c_cols, col_pos, adj, compact, counts, rows,
                                       ranks, tau, ell=ell, n_max=n_max)
        return L._winners(found, ranks, s_ids, None)

    ops.chunk_s_grid_tests = grid_tests
    ops.chunk_s_grid_tests_cols = grid_tests_cols
    spec = json.loads(sys.argv[1])
    out = {}
    for k, n, d, seed in spec["fixtures"]:
        x, _ = sample_gaussian_dag(n=n, m=spec["m"], density=d, seed=seed)
        base = pc(x, engine="S")
        np.savez(spec["single"], adj=base.adj, sepsets=base.sepsets, cpdag=base.cpdag,
                 levels_run=base.levels_run)
        mesh = SH.make_mesh(k)
        for name, kw in spec["combos"].items():
            snaps = {}
            cb = None
            if [k, n, d, seed] == spec["resume"] and name == "replicated":
                cb = lambda l, a, s: snaps.__setitem__(l, (np.asarray(a), np.asarray(s)))
            run = pc_distributed(x=x, mesh=mesh, checkpoint_cb=cb, **kw)
            out[f"{k}-{n}-{d}-{seed}-{name}"] = [
                {key: st[key] for key in spec["keys"] if key in st} for st in run.level_stats]
            if snaps:
                first = min(snaps)
                np.savez(spec["snapshot"], level=first, adj=snaps[first][0],
                         sep=snaps[first][1], full_adj=run.adj, full_sep=run.sepsets,
                         full_cpdag=run.cpdag)
    print(json.dumps(out))
""")


class _JaxStats:
    """JAX ``pc_distributed`` level stats, one subprocess a fixture, all
    started together."""

    def __init__(self, out: Path):
        env = {**os.environ, "JAX_PLATFORMS": "cpu",
               "PYTHONPATH": os.pathsep.join(filter(None, [str(ROOT / "src"),
                                                           os.environ.get("PYTHONPATH")]))}
        self.out = out
        self.snapshot = out / "snapshot.npz"
        self.procs = []
        for fx in FIXTURES:
            k = fx[0]
            spec = {"fixtures": [list(fx)], "m": M,
                    "combos": COMBOS, "keys": STAT_KEYS, "resume": list(RESUME),
                    "snapshot": str(self.snapshot), "single": str(self._single_path(fx))}
            self.procs.append(subprocess.Popen(
                [sys.executable, "-c", _JAX_SCRIPT, json.dumps(spec)],
                env={**env, "XLA_FLAGS": f"--xla_force_host_platform_device_count={k}"},
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        self._stats = None

    def stats(self) -> dict:
        if self._stats is None:
            self._stats = {}
            for p in self.procs:
                out, err = p.communicate(timeout=900)
                assert p.returncode == 0, err[-3000:]
                self._stats.update(json.loads(out.strip().splitlines()[-1]))
        return self._stats

    def _single_path(self, fx) -> Path:
        return self.out / ("single-%d-%d-%g-%d.npz" % fx)

    def single(self, fx) -> dict:
        """The JAX single-device ``pc(x, engine="S")`` of a fixture."""
        self.stats()
        return dict(np.load(self._single_path(fx)))

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These runs are thousands of small ops: with one intra-op thread a
    worker does not oversubscribe the cores it shares with the other test
    workers (and here, the JAX subprocesses)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    runs = _JaxStats(tmp_path_factory.mktemp("jax_distributed"))
    yield runs
    runs.close()


def _data(fx):
    _, n, d, seed = fx
    x, _ = sample_gaussian_dag(n=n, m=M, density=d, seed=seed)
    return x, np.asarray(correlation_from_samples(jnp.asarray(x)))


def _mesh(k):
    return S.make_mesh(devices=("cpu",) * k)


def _run(fx, combo, **kw):
    _, c = _data(fx)
    return pc_distributed(c=c, m=M, mesh=_mesh(fx[0]), **COMBOS[combo], **kw)


def _assert_run_equal(got, want, what=""):
    for f in ("adj", "sepsets", "cpdag"):
        want_f = want[f] if isinstance(want, dict) else getattr(want, f)
        np.testing.assert_array_equal(getattr(got, f), want_f, err_msg=f"{what} {f}")


CASES = [(fx, combo) for fx in FIXTURES for combo in COMBOS]
IDS = [f"{fx[0]}-{fx[1]}-{combo}" for fx, combo in CASES]


@pytest.mark.parametrize("fx,combo", CASES, ids=IDS)
def test_pc_distributed_bitwise_equal_to_jax_single_device(fx, combo, jax_runs):
    run = _run(fx, combo)
    want = jax_runs.single(fx)
    _assert_run_equal(run, want, combo)
    assert run.levels_run == int(want["levels_run"])
    ran = [st for st in run.level_stats if not st["skipped"]]
    assert ran
    kw = COMBOS[combo]
    for st in ran:
        assert st["shard_c"] == kw.get("shard_c", False)
        assert st["shard_sep"] == kw.get("shard_sep", False)
        if kw.get("engine") == "S-grid":
            assert st["dispatches"] == 1 and st["pipeline_depth"] == 1
        else:
            assert st["pipeline_depth"] == kw.get("pipeline_depth", 1)
    if kw.get("speculate"):
        assert all(st.get("speculative", False) for st in ran[1:])


@pytest.mark.parametrize("fx,combo", CASES, ids=IDS)
def test_level_stats_equal_jax_pc_distributed(fx, combo, jax_runs):
    got = [{k: st[k] for k in STAT_KEYS if k in st} for st in _run(fx, combo).level_stats]
    want = jax_runs.stats()[f"{fx[0]}-{fx[1]}-{fx[2]}-{fx[3]}-{combo}"]
    assert got == want


def test_resume_from_a_jax_checkpoint(jax_runs):
    """The JAX run's first per-level snapshot, carried across by
    ``state_from_numpy``, resumes (on 4 shards, sepsets row-sharded) to
    the uninterrupted JAX result."""
    jax_runs.stats()
    snap = np.load(jax_runs.snapshot)
    st = state_from_numpy(adj=snap["adj"], sep=snap["sep"], device="cpu")
    _, c = _data(RESUME)
    run = pc_distributed(c=c, m=M, mesh=_mesh(RESUME[0]), shard_sep=True,
                         resume=(int(snap["level"]), st.adj, st.sep))
    for f, key in (("adj", "full_adj"), ("sepsets", "full_sep"), ("cpdag", "full_cpdag")):
        np.testing.assert_array_equal(getattr(run, f), snap[key], err_msg=f)
    assert run.level_stats[0]["level"] == int(snap["level"]) + 1


def test_checkpoints_are_the_global_view_and_resume():
    """With row-sharded sepsets the callback gets the n-row global view,
    and each snapshot resumes to the uninterrupted run."""
    fx = (8, 17, 0.3, 2)
    snaps = {}
    full = _run(fx, "shard_c+sep", checkpoint_cb=lambda lv, a, s: snaps.__setitem__(
        lv, (a.clone(), s.clone())))
    assert snaps
    n = fx[1]
    for level, (a, s) in snaps.items():
        assert a.shape == (n, n) and s.shape == (n, n, 8)
        again = _run(fx, "shard_c+sep", resume=(level, a.numpy(), s.numpy()))
        _assert_run_equal(again, full, f"resume after {level}")


def test_column_cache_gathers_once_and_registry_agrees():
    """The cache pays one column gather a run; the uncached layout one a
    chunk; the metrics registry's sharded counters equal the stats."""
    fx = (8, 30, 0.2, 4)
    _, c = _data(fx)
    mesh = _mesh(fx[0])
    for kw in (dict(shard_c=True, cell_budget=2**9),
               dict(shard_c=True, cache_cols=False, cell_budget=2**9),
               dict(engine="S-grid")):
        with obs.scoped(enabled=True), obs.scoped_registry() as reg:
            run = pc_distributed(c=c, m=M, mesh=mesh, **kw)
            st = run.level_stats
            assert reg.total(obs.DISPATCHES, layout="sharded") == sum(s["dispatches"] for s in st)
            assert reg.total(obs.CHUNKS, layout="sharded") == sum(s["chunks"] for s in st)
            if kw.get("shard_c"):
                assert reg.total(obs.COL_GATHERS) == sum(s["col_gathers"] for s in st)
                assert reg.total(obs.COL_GATHER_BYTES) == sum(s["col_gather_bytes"] for s in st)
        if kw.get("cache_cols") is False:
            assert all(s["col_gathers"] == s["chunks"] for s in st)
            assert sum(s["chunks"] for s in st) > len(st)
        elif kw.get("shard_c"):
            assert [s["col_gathers"] for s in st] == [1] + [0] * (len(st) - 1)


def test_shard_c_memory_layout():
    """shard_c keeps (n_pad/K, n) rows of C a shard and gathers k < n
    columns; the layout descriptor names the row axis."""
    from repro_torch.core.distributed import shard_correlation

    n, k = 33, 8
    x, _ = sample_gaussian_dag(n=n, m=2000, density=0.05, seed=7)
    c = torch.tensor(np.asarray(correlation_from_samples(jnp.asarray(x))))
    mesh = _mesh(k)
    c_sh = shard_correlation(c, mesh)
    n_pad = n + S.pad_amount(n, mesh)
    assert c_sh.shape == (n_pad, n)
    assert c_sh.sharding == S.row_spec(mesh) and c_sh.sharding.spec == (S.AXIS,)
    assert [tuple(b.shape) for b in c_sh] == [(n_pad // k, n)] * k
    torch.testing.assert_close(c_sh.gather()[:n], c, rtol=0, atol=0)
    run = pc_distributed(c=c, m=2000, mesh=mesh, shard_c=True)
    assert run.level_stats
    for st in run.level_stats:
        assert st["shard_c"] and st["k_cols"] < n and S.AXIS in st["c_sharding"]


def test_bad_engine_and_speculation_are_refused():
    _, c = _data(FIXTURES[2])
    with pytest.raises(ValueError, match="'S' or 'S-grid'"):
        pc_distributed(c=c, m=M, mesh=_mesh(2), engine="E")
    with pytest.raises(ValueError, match="speculate=True requires"):
        pc_distributed(c=c, m=M, mesh=_mesh(2), speculate=True)
