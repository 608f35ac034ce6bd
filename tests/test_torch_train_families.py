"""The port's training path against the JAX package's, on the CPU, for the
architectures of the other segment kinds and families (reduced configs):
deepseek-v2-236b (MLA, a dense and an MoE segment), zamba2-1.2b (Mamba2
and the shared block at every site), rwkv6-3b and whisper-large-v3 (the
encoder-decoder; its batch carries frames).

The checks, their inputs and their tolerances are those of
test_torch_train_models.py (its docstring states them): ``loss`` and every
gradient leaf under remat, and one ``make_train_step`` with ``grad_accum``
2 and remat off.
"""
import pytest

pytest.importorskip("torch")

from test_torch_train_models import _one_thread  # noqa: E402,F401  (one intra-op thread)
from test_torch_train_models import check_loss_and_grads, check_train_step  # noqa: E402

pytestmark = pytest.mark.torch

ARCHS = ("deepseek-v2-236b", "zamba2-1.2b", "rwkv6-3b", "whisper-large-v3")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads(arch):
    check_loss_and_grads(arch)


@pytest.mark.parametrize("arch,accum,remat", [(a, 2, False) for a in ARCHS])
def test_train_step(arch, accum, remat):
    check_train_step(arch, accum, remat)
