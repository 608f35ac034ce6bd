"""The port's launchers (``repro_torch.launch.pc_run`` and ``pc_serve``)
against the JAX package's, run the way users run them.

The JAX launchers run in subprocesses (``JAX_PLATFORMS=cpu``), never
imported here: ``repro.launch.pc_run`` turns on ``jax_enable_x64`` at
import, which would change every later test on this worker. Four
subprocesses start together when the first test asks for them, and the
port's runs (``--device cpu``, in-process ``main``) go on meanwhile:

* ``pc_run --n 40 --m 2000 --d 0.15`` under "auto", "S", "E", "S-grid"
  and "scan": equal ``edges`` and ``levels`` (the reference with
  ``--corr jnp``, its name for the plain correlation);
* ``--batch 4 --n 24``: an equal ``schedule``;
* ``--bootstrap``: the port's record repeats under the same seed, and its
  keys equal the reference's (the resample draws differ by design:
  ROADMAP Queue 3, standing deviations);
* ``pc_serve --faults``: the same rejected, dead-letter, retry, tier and
  latency lines (the wall-clock numbers aside);
* every multi-device flag exits non-zero naming ROADMAP Queue 1 item 12.
"""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import pc_run, pc_serve  # noqa: E402

pytestmark = pytest.mark.torch

ROOT = Path(__file__).resolve().parents[1]
ENGINES = ("auto", "S", "E", "S-grid", "scan")
SINGLE = ("--n", "40", "--m", "2000", "--d", "0.15")
BATCH = ("--batch", "4", "--n", "24", "--m", "2000", "--d", "0.15")
BOOT = ("--bootstrap", "4", "--n", "24", "--m", "2000", "--d", "0.15", "--seed", "3")
MULTI_DEVICE = (("--devices", "2"), ("--mesh", "2"), ("--shard-batch",), ("--shard-c",),
                ("--shard-sep",), ("--speculate",), ("--no-cache-cols",))

# runs repro.launch.pc_run.main once per argv list (its parser reads sys.argv)
_RUNNER = """
import json, sys
from repro.launch import pc_run
for argv in json.loads(sys.argv[1]):
    sys.argv = ["pc_run", *argv]
    pc_run.main()
"""


class _Reference:
    """The JAX launchers' runs, in four subprocesses started together."""

    def __init__(self, out: Path):
        self.out = out
        env = {**os.environ, "JAX_PLATFORMS": "cpu",
               "PYTHONPATH": os.pathsep.join(filter(None, [str(ROOT / "src"),
                                                           os.environ.get("PYTHONPATH")]))}
        groups = [["auto"], ["S-grid"], ["S", "E", "scan", "batch", "bootstrap"]]
        self.procs = [subprocess.Popen([sys.executable, "-c", _RUNNER,
                                        json.dumps([self._argv(k) for k in g])],
                                       env=env, cwd=str(out), stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)
                      for g in groups]
        self.serve = subprocess.Popen([sys.executable, "-m", "repro.launch.pc_serve", "--faults"],
                                      env=env, cwd=str(out), stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True)
        self._done = False

    def _argv(self, kind):
        path = str(self.out / f"{kind}.json")
        if kind == "batch":
            return [*BATCH, "--corr", "jnp", "--json", path]
        if kind == "bootstrap":
            return [*BOOT, "--corr", "jnp", "--json", path]
        return [*SINGLE, "--corr", "jnp", "--engine", kind, "--json", path]

    def wait(self):
        if not self._done:
            for p in self.procs:
                _, err = p.communicate(timeout=600)
                assert p.returncode == 0, err[-3000:]
            self._done = True

    def record(self, kind) -> dict:
        self.wait()
        return json.loads((self.out / f"{kind}.json").read_text())

    def serve_stdout(self) -> str:
        out, err = self.serve.communicate(timeout=600)
        assert self.serve.returncode == 0, err[-3000:]
        return out

    def close(self):
        for p in (*self.procs, self.serve):
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    ref = _Reference(tmp_path_factory.mktemp("jax_launch"))
    yield ref
    ref.close()


def _port(tmp_path, *argv) -> dict:
    path = tmp_path / "port.json"
    assert pc_run.main([*argv, "--device", "cpu", "--json", str(path)]) == 0
    return json.loads(path.read_text())


@pytest.mark.parametrize("engine", ENGINES)
def test_pc_run_matches_reference(engine, reference, tmp_path):
    got = _port(tmp_path, *SINGLE, "--engine", engine)
    want = reference.record(engine)
    assert (got["edges"], got["levels"]) == (want["edges"], want["levels"])
    assert sorted(got) == sorted(want)
    assert set(got["timings_s"]) == set(want["timings_s"])


def test_pc_run_batch_schedule_matches_reference(reference, tmp_path):
    got = _port(tmp_path, *BATCH)
    want = reference.record("batch")
    assert got["schedule"] == want["schedule"]
    assert sorted(got) == sorted(want)
    assert {k: got[k] for k in ("mode", "n", "m", "batch", "max_level")} == \
        {k: want[k] for k in ("mode", "n", "m", "batch", "max_level")}


def test_pc_run_bootstrap_repeats_and_keeps_the_reference_keys(reference, tmp_path):
    journal = tmp_path / "boot.jsonl"
    first = _port(tmp_path, *BOOT, "--journal", str(journal))
    again = _port(tmp_path, *BOOT)
    drop = ("timings_s", "total_s")
    assert {k: v for k, v in first.items() if k not in drop} == \
        {k: v for k, v in again.items() if k not in drop}
    want = reference.record("bootstrap")
    assert sorted(first) == sorted(want)
    assert set(first["timings_s"]) == set(want["timings_s"])
    # the journal holds every phase with its duration, and the scope ended
    from repro_torch import obs

    assert not obs.enabled()
    phases = obs.phase_summary(obs.read_journal(str(journal)), depth=1)
    for k, v in first["timings_s"].items():
        if k != "total":
            assert phases[k] == v
    assert sum(phases.values()) <= first["total_s"]


@pytest.mark.parametrize("flags", MULTI_DEVICE, ids=lambda f: f[0])
def test_pc_run_refuses_multi_device(flags, capsys):
    assert pc_run.main([*SINGLE, "--device", "cpu", *flags]) != 0
    assert "ROADMAP Queue 1 item 12" in capsys.readouterr().err


def test_pc_serve_refuses_shard(capsys):
    assert pc_serve.main(["--shard", "--device", "cpu"]) != 0
    assert "ROADMAP Queue 1 item 12" in capsys.readouterr().err


def _outcome_lines(text: str) -> list:
    """pc_serve's summary without the wall-clock numbers."""
    lines = [ln for ln in text.splitlines() if ln.strip()]
    return [re.sub(r"in [0-9.]+s \([0-9.]+ req/s,", "in <wall> (<rate>,", ln) for ln in lines]


def test_pc_serve_faults_matches_reference(reference, capsys):
    assert pc_serve.main(["--faults", "--device", "cpu"]) == 0
    got = _outcome_lines(capsys.readouterr().out)
    want = _outcome_lines(reference.serve_stdout())
    assert got == want
    assert any("rejected=1 [('req-2', 'injected')]" in ln for ln in got)
    assert any("dead_letters=1 [('req-8', 'deadline', 'completed')]" in ln for ln in got)


def test_launchers_without_a_card_fail():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is the card")
    with pytest.raises(RuntimeError, match="CUDA"):
        pc_run.main([*SINGLE])
    with pytest.raises(RuntimeError, match="CUDA"):
        pc_serve.main(["--requests", "1"])
