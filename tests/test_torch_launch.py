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
* each multi-device flag under ``--devices 2`` (the port with
  ``--device cpu``: two CPU shards; the reference in a fifth subprocess
  with two forced host devices): the same lines, wall-clock timings
  aside, and equal ``edges`` and ``levels``;
* ``pc_serve --shard``: the same graphs as the unsharded service.
"""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import pc_run, pc_serve  # noqa: E402

pytestmark = pytest.mark.torch

ROOT = Path(__file__).resolve().parents[1]
ENGINES = ("auto", "S", "E", "S-grid", "scan")
SINGLE = ("--n", "40", "--m", "2000", "--d", "0.15")
BATCH = ("--batch", "4", "--n", "24", "--m", "2000", "--d", "0.15")
BOOT = ("--bootstrap", "4", "--n", "24", "--m", "2000", "--d", "0.15", "--seed", "3")
DIST = ("--n", "24", "--m", "2000", "--d", "0.15", "--devices", "2")
# each reference multi-device flag under --devices 2, with what it acts on
MULTI_DEVICE = {
    "devices": (),
    "mesh": ("--mesh", "2"),
    "shard-batch": ("--shard-batch", "--batch", "4"),
    "shard-c": ("--shard-c",),
    "shard-sep": ("--shard-sep", "--pipeline-depth", "2"),
    "speculate": ("--engine", "S-grid", "--speculate"),
    "no-cache-cols": ("--shard-c", "--no-cache-cols"),
}

# runs repro.launch.pc_run.main once per argv list (its parser reads sys.argv),
# each run's stdout after a marker line
_RUNNER = """
import json, sys
from repro.launch import pc_run
for argv in json.loads(sys.argv[1]):
    print("=== run", flush=True)
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
        self.multi = subprocess.Popen(
            [sys.executable, "-c", _RUNNER,
             json.dumps([[*DIST, *flags, "--json", str(out / f"multi-{k}.json")]
                         for k, flags in MULTI_DEVICE.items()])],
            env={**env, "XLA_FLAGS": "--xla_force_host_platform_device_count=2"},
            cwd=str(out), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self._multi = None
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

    def multi_run(self, kind) -> tuple:
        """(stdout lines, json record) of the reference's --devices 2 run."""
        if self._multi is None:
            out, err = self.multi.communicate(timeout=900)
            assert self.multi.returncode == 0, err[-3000:]
            runs = out.split("=== run\n")[1:]
            self._multi = dict(zip(MULTI_DEVICE, runs))
        rec = json.loads((self.out / f"multi-{kind}.json").read_text())
        return self._multi[kind], rec

    def serve_stdout(self) -> str:
        out, err = self.serve.communicate(timeout=600)
        assert self.serve.returncode == 0, err[-3000:]
        return out

    def close(self):
        for p in (*self.procs, self.serve, self.multi):
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


def _steady_lines(text: str) -> list:
    """pc_run's lines without the wall-clock ones (timings, totals, rates)."""
    wall = re.compile(r"^\s+(\S+: +[0-9.]+ ms|total: [0-9.]+ s|steady-state: .*)$")
    return [ln for ln in text.splitlines() if ln.strip() and not wall.match(ln)]


@pytest.mark.parametrize("kind", MULTI_DEVICE)
def test_pc_run_multi_device_flag_matches_reference(kind, reference, tmp_path, capsys):
    path = tmp_path / "port.json"
    argv = [*DIST, *MULTI_DEVICE[kind], "--device", "cpu", "--json", str(path)]
    assert pc_run.main(argv) == 0
    got_lines = _steady_lines(capsys.readouterr().out)
    got = json.loads(path.read_text())
    want_out, want = reference.multi_run(kind)
    assert got_lines == _steady_lines(want_out)
    assert sorted(got) == sorted(want)
    for key in ("edges", "levels", "schedule"):
        assert got.get(key) == want.get(key), key


def test_pc_serve_shard_equals_unsharded(capsys):
    """--shard --devices 2 on the CPU: the same outcome lines as the
    unsharded service and every graph equal (the fault stream on a
    ManualClock, so nothing depends on the wall clock)."""
    argv = ["--faults", "--device", "cpu", "--requests", "6"]
    args = pc_serve.parser().parse_args([*argv, "--shard", "--devices", "2"])
    sharded = pc_serve.serve(pc_serve.make_service(args), pc_serve.stream(args),
                             submit_all=True)[1]
    assert "[pc_serve] sharding slots over 2 devices" in capsys.readouterr().out
    plain_args = pc_serve.parser().parse_args(argv)
    plain = pc_serve.serve(pc_serve.make_service(plain_args), pc_serve.stream(plain_args),
                           submit_all=True)[1]
    assert sharded.steps == plain.steps and sharded.rejections.keys() == plain.rejections.keys()
    assert {k: sorted(v) for k, v in sharded.delivered.items()} == \
        {k: sorted(v) for k, v in plain.delivered.items()}
    for rid, lanes in plain.delivered.items():
        for lane, want in lanes.items():
            for f in ("adj", "cpdag", "sepsets", "tier"):
                np.testing.assert_array_equal(getattr(sharded.delivered[rid][lane], f),
                                              getattr(want, f), err_msg=f"{rid}/{lane} {f}")
    assert pc_serve.main([*argv, "--shard", "--devices", "2"]) == 0


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
