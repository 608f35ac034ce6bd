"""The port's contract suite (src/repro_torch/analysis/): per-rule fixtures,
analyzer regressions against the JAX package's analyzers, and the baseline
ratchet — ``tests/test_analysis.py``'s classes for the torch package.

Every rule gets a violation fixture that fires EXACTLY ONCE and a clean
twin that fires zero times. The card-only halves of Layer 3 (the poisoned
allocator, repeatability) carry the ``cuda`` marker and skip without a card;
the ptxas parser (RPR203) runs here on a committed fixture.
"""
from __future__ import annotations

import ast
import json
import re
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch.analysis import baseline as B
from repro_torch.analysis import cuda as CU
from repro_torch.analysis import dispatch as D
from repro_torch.analysis import rules as R
from repro_torch.analysis.findings import RULE_CATALOG, Finding

pytestmark = pytest.mark.torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"
needs_card = pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card")
HOT = frozenset({"core/mod.py::step"})


def _codes(findings):
    return [f.code for f in findings]


def _check(src, path="src/repro_torch/core/mod.py", allowlist=None, hot=HOT):
    return R.check_source(textwrap.dedent(src), path,
                          allowlist={} if allowlist is None else allowlist, hot=hot)


def _record(fn, *args):
    rec = D.Recorder()
    with rec:
        fn(*args)
    return rec


# --------------------------------------------------------------- layer 1
SYNC_FIXTURES = {
    ".item()": "lr = x.mean().item()",
    "int()": "lr = int(x.sum())",
    "nonzero": "lr = torch.nonzero(x).shape[0]",
    "torch.equal": "lr = torch.equal(x, x)",
    ".tolist()": "lr = x.tolist()",
}


class TestRPR001:
    CLEAN = """
    import torch

    def step(x):
        n = int(x.shape[0])
        return x * x.mean() + float(n)
    """

    @pytest.mark.parametrize("detail", list(SYNC_FIXTURES))
    def test_fires_once(self, detail):
        src = f"""
        import torch

        def step(x):
            {SYNC_FIXTURES[detail]}
            return x
        """
        fs = _check(src)
        assert _codes(fs) == ["RPR001"]
        assert fs[0].detail == detail

    def test_clean_twin(self):
        assert _check(self.CLEAN) == []

    def test_nested_function_of_a_hot_one(self):
        src = """
        def step(x):
            def body(y):
                return y.cpu()
            return body(x)
        """
        fs = _check(src)
        assert _codes(fs) == ["RPR001"] and fs[0].context == "body"


class TestRPR002:
    VIOLATION = """
    def collect(x):
        return int(x.max())
    """

    def test_fires_once(self):
        fs = _check(self.VIOLATION)
        assert _codes(fs) == ["RPR002"]
        assert fs[0].key == "RPR002 src/repro_torch/core/mod.py::collect::int()"

    def test_clean_when_allowlisted(self):
        key = "RPR002 src/repro_torch/core/mod.py::collect::int()"
        assert _check(self.VIOLATION, allowlist={key: "test seam"}) == []

    def test_launch_and_analysis_are_exempt(self):
        assert _check(self.VIOLATION, path="src/repro_torch/launch/mod.py") == []
        assert _check(self.VIOLATION, path="src/repro_torch/analysis/mod.py") == []

    def test_cpu_numpy_pair_collapses_to_one_key(self):
        fs = _check("def materialize(x):\n    return x.cpu().numpy()\n")
        assert _codes(fs) == ["RPR002"]
        assert fs[0].detail == ".cpu().numpy()"

    def test_host_values_do_not_fire(self):
        src = """
        import numpy as np

        def plan(c, a, tau: float):
            arities = np.asarray(a).max(axis=0) + 1
            i, j = np.nonzero(np.triu(a, 1))
            return int(arities.max()), float(tau), int(c.shape[0]), i.tolist()
        """
        assert _check(src) == []


class TestRPR003:
    VIOLATION = """
    import time

    def tick():
        return time.perf_counter()
    """

    def test_fires_once(self):
        assert _codes(_check(self.VIOLATION)) == ["RPR003"]

    def test_obs_is_the_sanctioned_home(self):
        assert _check(self.VIOLATION, path="src/repro_torch/obs/clock.py") == []

    def test_bare_import_alias_counts(self):
        assert _codes(_check("from time import perf_counter\n")) == ["RPR003"]


class TestRPR004:
    VIOLATION = """
    def my_kernel(x, *, plain=False):
        if plain or x.device.type == "cpu":
            return my_kernel_plain(x)
        build.launch("k", "repro_k", x.device, x.data_ptr())
        return x
    """
    CLEAN = """
    def my_kernel(x):
        if x.device.type == "cpu":
            return my_kernel_plain(x)
        build.launch("k", "repro_k", x.device, x.data_ptr())
        return x
    """
    FALLBACK = """
    def my_kernel(x):
        try:
            build.launch("k", "repro_k", x.device, x.data_ptr())
        except RuntimeError:
            return my_kernel_plain(x.cpu())
        return x
    """

    def test_fires_once(self):
        fs = _check(self.VIOLATION, path="src/repro_torch/kernels/mod.py")
        assert _codes(fs) == ["RPR004"] and fs[0].detail == "plain-choice:my_kernel_plain"

    def test_clean_twin(self):
        assert _check(self.CLEAN, path="src/repro_torch/kernels/mod.py") == []

    def test_fallback_around_launch(self):
        fs = _check(self.FALLBACK, path="src/repro_torch/kernels/mod.py")
        codes = [f for f in fs if f.code == "RPR004"]
        assert len(codes) == 1 and codes[0].detail == "fallback:my_kernel_plain"


class TestRPR005:
    def test_bare_lru_cache_fires_once(self):
        src = """
        import functools

        @functools.lru_cache
        def plan(n):
            return n
        """
        fs = _check(src)
        assert _codes(fs) == ["RPR005"] and fs[0].detail == "lru_cache-maxsize"

    def test_functools_cache_fires_once(self):
        src = "import functools\n\n@functools.cache\ndef plan(n):\n    return n\n"
        assert _codes(_check(src)) == ["RPR005"]

    def test_literal_maxsize_is_clean(self):
        src = "import functools\n\n@functools.lru_cache(maxsize=16)\ndef plan(n):\n    return n\n"
        assert _check(src) == []

    def test_capture_key_field_fires_once(self):
        src = """
        from . import capture

        def record(inputs, taus, mode, dev):
            key = ("pc_scan", tuple(inputs[0].shape), taus, mode)
            return capture.run(key + (str(dev),), fn, inputs)
        """
        fs = _check(src, path="src/repro_torch/batch/mod.py")
        assert _codes(fs) == ["RPR005"] and fs[0].detail == "capture-key:mode"

    def test_capture_key_clean_twin(self):
        src = """
        from . import capture

        def record(inputs, taus, sepset_depth, dev):
            static = dict(schedule=(4, 4), jitter=1e-8)
            key = ("pc_scan", tuple(inputs[0].shape), taus, sepset_depth, *static.values())
            return capture.run(key + (str(dev),), fn, inputs)
        """
        assert _check(src, path="src/repro_torch/batch/mod.py") == []


# --------------------------------------------------------------- layer 2
class TestRPR101:
    def test_fires_once(self):
        rec = _record(lambda x: x + torch.tensor(1.0, dtype=torch.float64), torch.zeros(4))
        assert _codes(D.promotion_findings(rec, "promote", "<t>")) == ["RPR101"]

    def test_clean_twin(self):
        rec = _record(lambda x: (x + 1.0).to(torch.int64), torch.zeros(4))
        assert D.promotion_findings(rec, "stay_f32", "<t>") == []


class TestRPR102:
    FIXTURES = {
        ".item()": lambda x: x.sum().item(),
        "int()": lambda x: int(x.sum()),
        "nonzero": lambda x: torch.nonzero(x),
        "equal": lambda x: torch.equal(x, x),
    }

    @pytest.mark.parametrize("prim", list(FIXTURES))
    def test_fires_once(self, prim):
        rec = _record(self.FIXTURES[prim], torch.ones(4))
        fs, seams = D.sync_findings(rec.syncs, prim)
        assert _codes(fs) == ["RPR102"] and seams == 0

    def test_tolist_dispatches_nothing_on_the_cpu_and_layer1_sees_it(self):
        rec = _record(lambda x: x.tolist(), torch.ones(4))
        assert rec.syncs == []
        assert _codes(_check("def step(x):\n    return x.tolist()\n")) == ["RPR001"]

    def test_clean_twin(self):
        rec = _record(lambda x: (x * 2).sum(dim=0), torch.ones(4))
        assert D.sync_findings(rec.syncs, "clean") == ([], 0)

    def test_allowlisted_seam_is_counted_not_reported(self):
        fs, seams = D.sync_findings(
            [("_local_scalar_dense", ("core/levels.py", "run_level", 1))], "seam")
        assert fs == [] and seams == 1

    def test_unlisted_path_function_fires_once(self):
        """The recorder sees chunk_s's path: with one of its functions taken
        out of the HOT table, exactly that function is reported."""
        entry = next(e for e in D.entry_points() if e.name == "chunk_s")
        fs, _ = D.run_entry(entry, torch.device("cpu"),
                            hot=R.HOT - {"core/levels.py::_winners"})
        assert _codes(fs) == ["RPR102"] and fs[0].detail == "unlisted:core/levels.py::_winners"


class TestRPR103:
    def test_kernel_count_fires_once(self):
        assert _codes(D.kernel_count_findings(2, 1, "x", "<t>")) == ["RPR103"]

    def test_kernel_count_clean(self):
        assert D.kernel_count_findings(1, 1, "x", "<t>") == []

    def test_declared_count_is_enforced(self):
        e = next(e for e in D.entry_points() if e.name == "chunk_s_kernel")
        wrong = D.Entry(**{**e.__dict__, "cpu": 2})
        fs, row = D.run_entry(wrong, torch.device("cpu"))
        assert _codes(fs) == ["RPR103"] and row["kernels"] == 1

    def test_census(self):
        assert _codes(D.census_findings({"skernel": 1}, {"skernel": 2, "corr": 0},
                                        "p", "<t>")) == ["RPR103"]
        assert D.census_findings({"skernel": 2}, {"skernel": 2, "corr": 0}, "p", "<t>") == []

    STATS = {
        "broken_chunks": [{"engine": "S", "total_sets": 100, "n_chunk": 32, "chunks": 3,
                           "dispatches": 3, "pipeline_depth": 1}],
        "broken_multiplier": [{"engine": "S", "total_sets": 64, "n_chunk": 32, "chunks": 2,
                               "dispatches": 2, "pipeline_depth": 2}],
        "clean": [{"engine": "S", "total_sets": 100, "n_chunk": 32, "chunks": 4,
                   "dispatches": 4, "pipeline_depth": 1},
                  {"engine": "S", "total_sets": 64, "n_chunk": 32, "chunks": 2,
                   "dispatches": 4, "pipeline_depth": 2},
                  {"skipped": True}],
    }

    @pytest.mark.parametrize("case", list(STATS))
    def test_stats_contract_agrees_with_the_jax_package(self, case):
        from repro.analysis import jaxpr as J

        got = D.stats_contract_findings(self.STATS[case])
        want = J.stats_contract_findings(self.STATS[case])
        assert [(f.code, f.context, f.detail, f.message) for f in got] == \
            [(f.code, f.context, f.detail, f.message) for f in want]
        assert len(got) == (0 if case == "clean" else 1)


def _leaky_plan(npr, ell, n_rows):
    from math import comb

    return npr, 64, comb(npr, ell)


class TestRPR104:
    def test_fires_on_overflowing_plan_as_the_jax_package(self):
        from repro.analysis import jaxpr as J

        imax = torch.iinfo(torch.int32).max // 4
        got = D.rank_capacity_findings(plan_fn=_leaky_plan, imax=imax, n_max=50)
        want = J.rank_capacity_findings(plan_fn=_leaky_plan, imax=imax, n_max=50)
        assert got and set(_codes(got)) == {"RPR104"}
        assert [(f.context, f.detail) for f in got] == [(f.context, f.detail) for f in want]

    @pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
    def test_real_planner_is_clean(self, dtype):
        assert D.rank_capacity_findings(n_max=64, rank_dtype=dtype) == []
        assert D.guard_findings(rank_dtype=dtype) == []

    def test_real_planners_agree(self):
        from repro.analysis import jaxpr as J

        assert D.rank_capacity_findings(n_max=64) == J.rank_capacity_findings(n_max=64) == []

    def test_guard_raises_in_the_gap_region(self):
        from repro_torch.core import levels as L

        with pytest.raises(ValueError, match="commit-key capacity"):
            L.plan_level(47, 8, n_rows=8)

    def test_broken_guard_fires(self):
        fs = D.guard_findings(check_fn=lambda total, n_chunk, ell, dt: n_chunk)
        assert fs and set(_codes(fs)) == {"RPR104"}


def test_entry_registry_covers_every_engine():
    from repro_torch.core.engines import ENGINE_NAMES

    covered = {eng for e in D.entry_points() for eng in e.engines}
    assert set(ENGINE_NAMES) <= covered
    names = {e.name for e in D.entry_points()}
    assert {"chunk_s", "chunk_e", "chunk_s_kernel", "chunk_s_grid", "chunk_g2",
            "chunk_g2_kernel", "level1_dense", "pc_scan"} <= names


def test_declared_table_beside_the_reference():
    """Each row states the reference's pallas_call count; where the port's
    card count differs, the row says why."""
    from repro.analysis import jaxpr as J

    ref = {e.name: e.pallas_calls for e in J.entry_points()}
    for e in D.entry_points():
        name = {"gsq": "gsq_cells", "correlation_split_k": "correlation"}.get(e.name, e.name)
        if e.reference is not None:
            assert ref[name] == e.reference, e.name
        if e.reference is None or e.cuda != e.reference or e.cpu != e.reference:
            assert e.why, e.name
    chunk_s_kernel = next(e for e in D.entry_points() if e.name == "chunk_s_kernel")
    assert (chunk_s_kernel.cuda, chunk_s_kernel.reference) == (1, 2)


@pytest.fixture(scope="module")
def cpu_report():
    from repro_torch.analysis import run_all

    return run_all(str(ROOT), layers=(1, 2), device="cpu")


def test_layers_1_2_are_clean_on_the_cpu(cpu_report):
    assert cpu_report.findings == [], "\n".join(f.format() for f in cpu_report.findings)
    for row in cpu_report.tables["entries"]:
        assert row["kernels"] == row["declared"] and row["f64_ops"] == 0, row
    scan = next(r for r in cpu_report.tables["entries"] if r["name"] == "pc_scan")
    assert scan["seam_syncs"] > 0  # orientation, an allowlisted seam (item 10c)
    for row in cpu_report.tables["contract"]:
        assert min(row["chunks"]) > 1, row  # several chunks a level: the arithmetic bites
    pipelined = cpu_report.tables["contract"][-1]
    assert pipelined["dispatches"] == [2 * c for c in pipelined["chunks"]]


# --------------------------------------------------------------- layer 3
FIXTURE = (ROOT / "tests" / "fixtures" / "ptxas_torch.txt").read_text()


class TestRPR203:
    def test_parser_reads_the_fixture(self):
        rows = {r["symbol"]: r for r in CU.parse_ptxas(FIXTURE)}
        assert len(rows) == 6
        syrk = next(r for s, r in rows.items() if "syrk_kernel" in s)
        assert (syrk["registers"], syrk["smem"], syrk["source"]) == (233, 0, "corr.cu")
        sweep = next(r for s, r in rows.items() if "SgridMath" in s)
        assert (sweep["spill_stores"], sweep["spill_loads"], sweep["stack"]) == (8, 8, 8)

    def test_spill_and_over_budget_fire_once_each(self):
        fs, rows = CU.resource_findings(FIXTURE)
        assert sorted((f.context, f.detail) for f in fs) == [
            ("SgridMath<3>", "spills"), ("cisweep_kernel<8>", "smem")]
        syrk = next(r for r in rows if r["function"] == "syrk_kernel<128,4>")
        assert syrk["dyn_smem"] == 98304 and syrk["smem_limit"] == CU.OPTIN_SMEM

    def test_clean_twin(self):
        clean = FIXTURE.replace("40000 bytes smem", "4000 bytes smem").replace(
            "8 bytes spill stores, 8 bytes spill loads",
            "0 bytes spill stores, 0 bytes spill loads")
        assert CU.resource_findings(clean)[0] == []

    def test_register_budget(self):
        fs, _ = CU.resource_findings(FIXTURE, regs_per_block=8192)
        assert ("syrk_kernel<128,4>", "registers") in {(f.context, f.detail) for f in fs}

    def test_every_launcher_row_cites_its_launch(self):
        for res in CU.RESOURCES:
            path, line = res.launcher.rsplit(":", 1)
            text = (ROOT / path).read_text().splitlines()[int(line) - 1]
            assert "<<<" in text, res
            kernel = res.match if res.match.endswith("_kernel") else "sweep_kernel"
            assert kernel in text, res
        assert {name for _, name in CU.KERNEL_NAMES} <= {r.kernel for r in CU.RESOURCES}


def test_layer3_raises_without_a_card():
    from repro_torch.analysis import run_all

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        CU.all_findings("cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_all(str(ROOT), layers=(3,), device=None)


def test_poisoned_ranges_and_plain_band():
    t = torch.arange(8, dtype=torch.int32)
    lo = t.data_ptr()
    assert CU._in_ranges(t, [(lo, lo + 16), (lo + 16, lo + 32)])  # merged neighbours
    assert not CU._in_ranges(t, [(lo + 4, lo + 64)])
    got = (torch.tensor([1, 0, 1]),)

    def plain(shift):
        return (torch.tensor([1, 1 if shift > 0 else 0, 1]),)
    assert CU.plain_agrees(got, plain, "band")  # the middle cell is in the band
    assert not CU.plain_agrees((torch.tensor([0, 0, 1]),), plain, "band")


class TestRPR201202:
    """The verdict of Layer 3 on what ran (the poisoned runs themselves
    need the card: TestRPR201202OnTheCard)."""

    CASE = CU.KernelCase("toy", "toy", "<toy>", None)
    GOOD = (torch.tensor([7, 7, 7], dtype=torch.uint8),)

    def _plain(self, shift=0.0):
        return self.GOOD

    def test_unwritten_cell_fires_once(self):
        runs = [(torch.tensor([255, 7, 7], dtype=torch.uint8),), self.GOOD]
        fs, row = CU.judge_case(self.CASE, runs, True, [self.GOOD, self.GOOD], self._plain)
        assert _codes(fs) == ["RPR201"] and fs[0].detail == "coverage"
        assert not row["poison_equal"]

    def test_poison_that_missed_fires_once(self):
        runs = [self.GOOD, self.GOOD]
        fs, _ = CU.judge_case(self.CASE, runs, False, [self.GOOD, self.GOOD], self._plain)
        assert _codes(fs) == ["RPR201"] and fs[0].detail == "poison-missed"

    def test_race_fires_once(self):
        other = (torch.tensor([7, 8, 7], dtype=torch.uint8),)
        fs, _ = CU.judge_case(self.CASE, [self.GOOD, self.GOOD], True, [self.GOOD, other],
                              self._plain)
        assert _codes(fs) == ["RPR202"]

    def test_clean_twin(self):
        fs, row = CU.judge_case(self.CASE, [self.GOOD, self.GOOD], True,
                                [self.GOOD, self.GOOD], self._plain)
        assert fs == [] and all(v for k, v in row.items() if k.endswith(("_equal", "landed")))


def _case(kernel):
    return CU.KernelCase("toy", "toy", "<toy>", lambda dev: (kernel, lambda s=0.0: kernel()))


@pytest.mark.cuda
@needs_card
class TestRPR201202OnTheCard:
    def test_unwritten_cell_fires_once(self):
        dev = torch.device("cuda")

        def holey():
            out = torch.empty(64, dtype=torch.uint8, device=dev)
            out[1:].fill_(7)  # cell 0 keeps whatever the allocator held
            return out

        fs, _ = CU.check_case(_case(holey), dev)
        assert _codes(fs) == ["RPR201"] and fs[0].detail == "coverage"

    def test_race_fires_once(self):
        dev = torch.device("cuda")
        calls = []

        def racy():
            calls.append(1)  # warm, two poisoned runs, then two that differ
            return torch.full((64,), len(calls) == 5, device=dev)

        fs, _ = CU.check_case(CU.KernelCase("toy", "toy", "<toy>", lambda d: (
            racy, lambda s=0.0: torch.full((64,), False, device=dev))), dev)
        assert _codes(fs) == ["RPR202"]

    def test_every_kernel_entry_is_clean(self):
        fs, tables = CU.all_findings("cuda")
        assert fs == [], "\n".join(f.format() for f in fs)
        assert len({r["kernel"] for r in tables["kernels"]}) == 8


# --------------------------------------------------------------- baseline
class TestBaselineRatchet:
    F = Finding(code="RPR002", path="src/repro_torch/core/mod.py", line=3,
                message="m", context="fn", detail="int()")

    def test_new_finding_fails(self):
        new, stale, accepted = B.compare([self.F], [])
        assert new == [self.F] and not stale and not accepted

    def test_accepted_finding_passes(self):
        entry = B.BaselineEntry(key=self.F.key, justification="known debt")
        new, stale, accepted = B.compare([self.F], [entry])
        assert not new and not stale and accepted == [self.F]

    def test_stale_entry_fails(self):
        entry = B.BaselineEntry(key="RPR999 gone::x::y", justification="old")
        new, stale, accepted = B.compare([], [entry])
        assert not new and stale == [entry]

    def test_key_is_line_independent(self):
        moved = Finding(code="RPR002", path=self.F.path, line=99, message="m",
                        context="fn", detail="int()")
        assert moved.key == self.F.key

    @pytest.mark.parametrize("just", ["  ", B.TODO])
    def test_load_rejects_empty_or_todo_justification(self, tmp_path, just):
        p = tmp_path / "b.json"
        p.write_text(json.dumps({"version": 1, "entries": [{"key": "RPR001 a::b::c",
                                                            "justification": just}]}))
        with pytest.raises(ValueError, match="no justification"):
            B.load(p)

    def test_write_preserves_justifications(self, tmp_path):
        p = tmp_path / "b.json"
        B.write(p, [self.F])
        data = json.loads(p.read_text())
        data["entries"][0]["justification"] = "because reasons"
        p.write_text(json.dumps(data))
        B.write(p, [self.F])
        assert B.load(p)[0].justification == "because reasons"

    def test_cli_stale_baseline_fails(self, tmp_path, capsys):
        from repro_torch.analysis.__main__ import main

        p = tmp_path / "b.json"
        p.write_text(json.dumps({"version": 1, "entries": [
            {"key": "RPR001 src/repro_torch/gone.py::fn::.item()",
             "justification": "stale on purpose"}]}))
        rc = main(["--layers", "1", "--root", str(ROOT), "--baseline", str(p)])
        assert rc == 1
        assert "stale" in capsys.readouterr().out

    def test_cli_clean_layer1_passes(self, capsys):
        from repro_torch.analysis.__main__ import main

        rc = main(["--layers", "1", "--root", str(ROOT), "--format", "github"])
        out = capsys.readouterr().out
        assert rc == 0, out
        assert "new=0 stale=0" in out

    def test_cli_new_finding_fails(self, tmp_path, capsys):
        from repro_torch.analysis.__main__ import main

        root = tmp_path / "repo"
        mod = root / "src" / "repro_torch" / "core"
        mod.mkdir(parents=True)
        (mod / "m.py").write_text("def f(x):\n    return x.item()\n")
        rc = main(["--layers", "1", "--root", str(root)])
        assert rc == 1 and "RPR002" in capsys.readouterr().out


# ------------------------------------------------------------ repo sweep
def test_layer1_sweep_is_clean_with_real_allowlist():
    fs = R.check_tree(ROOT)
    assert fs == [], "\n".join(f.format() for f in fs)


def test_allowlist_entries_all_fire_and_say_why():
    fired = {f.key for f in R.check_tree(ROOT, allowlist={})}
    dead = [k for k in R.ALLOWLIST if k not in fired]
    assert not dead, f"allowlist entries no longer fire: {dead}"
    assert all(why.strip() and "\n" not in why for why in R.ALLOWLIST.values())


def test_hot_table_names_real_functions():
    defs = set()
    for f in PKG.rglob("*.py"):
        rel = f.relative_to(PKG).as_posix()
        defs |= {f"{rel}::{n.name}" for n in ast.walk(ast.parse(f.read_text()))
                 if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    assert R.HOT <= defs, sorted(R.HOT - defs)


def test_committed_baseline_loads_and_is_empty():
    assert B.load(ROOT / B.BASELINE_NAME) == []
    assert json.loads((ROOT / B.BASELINE_NAME).read_text())["entries"] == []


def test_orphan_report_is_quiet():
    from repro_torch.analysis import imports as I

    assert I.orphans(ROOT) == []


def test_rule_catalog_and_numpy_free_modules():
    assert len(RULE_CATALOG) == 12, sorted(RULE_CATALOG)
    assert {c[:4] for c in RULE_CATALOG} == {"RPR0", "RPR1", "RPR2"}
    for name in ("findings.py", "baseline.py", "imports.py"):
        src = (PKG / "analysis" / name).read_text()
        assert not re.search(r"^\s*(import|from)\s+(numpy|torch|jax|repro\b)", src, re.M), name
