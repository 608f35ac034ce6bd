"""End to end, part two: the certify and engine-matrix fixtures of
tests/test_engines.py (lines 60 and 272) against JAX's engine "auto", and
the port's entry points: the rank dtype, chunking and level-cap
switches, validation, the engine registry against the reference's, the
default device, the import rule and chip_smoke.py's refusal without a
card.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.cit import correlation_from_samples  # noqa: E402
from repro.core.cit import threshold as jthreshold  # noqa: E402
from repro.core import engines as jengines  # noqa: E402
from repro.core.pc import pc as jpc, pc_from_corr as jpc_from_corr  # noqa: E402
from repro.data.synthetic_dag import sample_gaussian_dag  # noqa: E402
from repro_torch import pc, pc_from_corr  # noqa: E402
from repro_torch.core import engines  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from test_torch_pc import assert_same_run  # noqa: E402

pytestmark = pytest.mark.torch

ROOT = Path(__file__).resolve().parent.parent


def test_certify_fixture_matches_reference_auto():
    """test_auto_sepsets_certify_removals' fixture: equal to JAX, and every
    recorded sepset passes the CI test it claims."""
    m, alpha = 3000, 0.01
    x, _ = sample_gaussian_dag(n=18, m=m, density=0.25, seed=11)
    c = correlation_from_samples(jnp.asarray(x))
    ref = jpc_from_corr(c, m, alpha=alpha, engine="auto")
    port = pc_from_corr(np.array(c), m, alpha=alpha, engine="auto", device="cpu")
    assert_same_run(port, ref)
    c64 = np.array(c, dtype=np.float64)
    checked = 0
    for (i, j), ids in port.sepset_dict().items():
        if ids:  # ρ(i, j | S) in float64 from the same C
            s = list(ids)
            sol = np.linalg.solve(c64[np.ix_(s, s)], np.stack([c64[s, i], c64[s, j]], axis=1))
            h = np.array([[1.0, c64[i, j]], [c64[i, j], 1.0]]) - \
                np.stack([c64[i, s], c64[j, s]]) @ sol
            rho = h[0, 1] / np.sqrt(h[0, 0] * h[1, 1])
            assert abs(np.arctanh(rho)) <= jthreshold(m, len(ids), alpha) + 1e-4, (i, j, ids)
            checked += 1
    assert checked > 0


def test_engine_matrix_fixture_matches_reference_auto():
    """test_engine_matrix_gaussian_citest_bit_identity's fixture: the port's
    "auto" and "S-kernel", with and without an explicit GaussianCITest,
    against JAX's "auto"."""
    from repro_torch.core.cit import GaussianCITest

    m = 2500
    x, _ = sample_gaussian_dag(n=20, m=m, density=0.25, seed=9)
    c = correlation_from_samples(jnp.asarray(x))
    ref = jpc_from_corr(c, m, alpha=0.01, engine="auto")
    c_np = np.array(c)
    assert_same_run(pc_from_corr(c_np, m, alpha=0.01, device="cpu"), ref)
    via = pc_from_corr(c_np, m, alpha=0.01, device="cpu", test=GaussianCITest(m=m, alpha=0.01))
    assert_same_run(via, ref)
    sk = pc_from_corr(c_np, m, alpha=0.01, device="cpu", engine="S-kernel")
    np.testing.assert_array_equal(sk.adj, ref.adj)
    np.testing.assert_array_equal(sk.sepsets, ref.sepsets)


def test_wide_ranks_chunking_and_level_cap():
    x, _ = sample_gaussian_dag(n=18, m=3000, density=0.3, seed=3)
    c = np.array(correlation_from_samples(jnp.asarray(x)))
    base = pc_from_corr(c, 3000, alpha=0.05, device="cpu")
    wide = pc_from_corr(c, 3000, alpha=0.05, device="cpu", wide_ranks=True)
    small = pc_from_corr(c, 3000, alpha=0.05, device="cpu", cell_budget=2**8)
    assert any(st["chunks"] > 1 for st in small.level_stats if not st["skipped"])
    for run in (wide, small):
        np.testing.assert_array_equal(run.adj, base.adj)
        np.testing.assert_array_equal(run.sepsets, base.sepsets)
    capped = pc_from_corr(c, 3000, alpha=0.05, device="cpu", max_level=1)
    assert capped.levels_run == 1 and [st["level"] for st in capped.level_stats] == [1]
    assert base.levels_run > 1 and (capped.adj >= base.adj).all()


def test_validation_and_engine_errors():
    from repro_torch.core import validate as V

    x, _ = sample_gaussian_dag(n=8, m=200, density=0.3, seed=0)
    bad = x.copy()
    bad[3, 2] = np.nan
    with pytest.raises(V.NonFiniteDataError):
        pc(bad, device="cpu")
    const = x.copy()
    const[:, 1] = 1.0
    with pytest.raises(V.ConstantColumnError):
        pc(const, device="cpu")
    with pytest.raises(V.BadCorrelationError):
        pc_from_corr(np.ones((3, 4)), 100, device="cpu")
    # every Gaussian engine is ported: the registry resolves as the reference's
    for name in ("S", "E", "S-kernel", "S-grid", "L1-dense", "auto"):
        for ell in range(1, 5):
            assert engines.resolve(name, ell) == jengines.resolve(name, ell), (name, ell)
    # "scan" is a whole-run engine on both routes, with the reference's results
    assert engines.is_whole_run("scan") and jengines.is_whole_run("scan")
    for xs, kw in ((x, {}), ((x > 0).astype(np.int64), dict(test="discrete"))):
        got = pc(xs, device="cpu", engine="scan", max_level=2, **kw)
        want = jpc(xs, engine="scan", max_level=2, **kw)
        np.testing.assert_array_equal(got.adj, want.adj)
        np.testing.assert_array_equal(got.sepsets, want.sepsets)
        assert got.level_stats == want.level_stats
    with pytest.raises(ValueError, match="raw samples"):
        pc_from_corr(np.eye(4, dtype=np.float32), 200, device="cpu", test="discrete")
    with pytest.raises(ValueError, match="unknown engine"):
        engines.resolve("warp", 1)
    assert engines.resolve("auto", 1) == "L1-dense"
    assert engines.resolve("AUTO", 3) == "S-kernel"
    assert engines.resolve(lambda ell: "S-kernel", 1) == "S-kernel"


def test_default_device_is_the_card():
    """device=None means CUDA: without a card the entry points raise, and a
    CPU run never launches a kernel."""
    x, _ = sample_gaussian_dag(n=8, m=200, density=0.3, seed=0)
    build.reset_launches()
    pc(x, device="cpu")
    assert sum(build.LAUNCHES.values()) == 0
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        pc(x)
    with pytest.raises(RuntimeError, match="CUDA"):
        pc_from_corr(np.eye(4, dtype=np.float32), 200)


def test_port_imports_no_jax_and_nothing_of_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    pat = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)(\.|\s+import)\b)", re.M)
    offenders = [str(f) for f in files if pat.search(f.read_text())]
    assert not offenders, offenders


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result without CUDA, and
    when it stands alone without the package."""
    import shutil
    import subprocess
    import sys

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    for script in (ROOT / "chip_smoke.py", alone):
        proc = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                              timeout=120, cwd=script.parent)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
