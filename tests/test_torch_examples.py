"""The four examples of the port (``examples/torch_*.py``), each run in
this process on the CPU at a reduced size, with its own checks, and an
AST check that none of them imports the JAX package or JAX.

* ``torch_grn_discovery`` with ``--serial-check`` at n = 20: the "E" and
  "S" skeletons equal each other and the serial oracle
  (``core.stable_ref.pc_stable_skeleton``) on the reference's data;
* ``torch_quickstart`` at its size (n = 40, m = 4000, 24 resamples);
* ``torch_train_lm`` through ``main`` with a narrow config (d_model 128,
  2 layers, vocabulary 256) for 25 steps of 2 × 16: the loss falls;
* ``torch_activation_causal`` for 5 steps.
"""
import ast
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS  # noqa: E402

pytestmark = [pytest.mark.torch]

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
NAMES = ("torch_quickstart", "torch_grn_discovery", "torch_train_lm", "torch_activation_causal")


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _example(name):
    sys.path.insert(0, str(EXAMPLES))
    try:
        return __import__(name)
    finally:
        sys.path.remove(str(EXAMPLES))


@pytest.mark.parametrize("name", NAMES)
def test_example_imports_no_jax(name):
    tree = ast.parse((EXAMPLES / f"{name}.py").read_text())
    mods = {a.name for node in ast.walk(tree) if isinstance(node, ast.Import) for a in node.names}
    mods |= {node.module for node in ast.walk(tree) if isinstance(node, ast.ImportFrom)}
    roots = {m.split(".")[0] for m in mods if m}
    assert not roots & {"jax", "jaxlib", "repro"}, roots
    assert "repro_torch" in roots


def test_grn_discovery_matches_serial_oracle():
    out = _example("torch_grn_discovery").main(
        ["--n", "20", "--m", "500", "--density", "0.15", "--serial-check", "--device", "cpu"])
    assert np.array_equal(out["E"].adj, out["S"].adj)
    assert np.array_equal(out["serial"].adj, out["S"].adj)
    assert out["S"].adj.sum() > 0


def test_quickstart():
    out = _example("torch_quickstart").main(["--device", "cpu"])
    assert out["single"].adj.shape == (40, 40)
    assert out["ensemble"].n_boot == 24
    assert out["freq_true"] > out["freq_false"]


def test_train_lm_loss_falls(tmp_path):
    cfg = dataclasses.replace(ARCHS["qwen3-1.7b"].reduced(), name="tiny", d_model=128,
                              n_layers=2, n_heads=4, n_kv=2, d_head=16, d_ff=128, vocab=256)
    out = _example("torch_train_lm").main(
        ["--steps", "25", "--batch", "2", "--seq", "16", "--device", "cpu",
         "--ckpt", str(tmp_path)], cfg=cfg)
    assert len(out["losses"]) == 25 and out["losses"][-1] < out["losses"][0]


def test_activation_causal():
    out = _example("torch_activation_causal").main(["--steps", "5", "--device", "cpu"])
    assert out["acts"].shape == (8 * 64, 64)
    assert all(np.isfinite(out["losses"]))
    assert 0 < out["edges"] <= out["total"] == 64 * 63 // 2
