"""The port's training path against the JAX package's, on the CPU, for one
architecture of each attention segment kind and family (reduced configs):
dense qwen3-1.7b, starcoder2-15b (bias, LayerNorm, ungated MLP), vlm
paligemma-3b (prefix mask, text-only loss) and qwen2-moe-a2.7b (top-k
routing with capacity drops and the aux loss). The same checks run on
deepseek-v2-236b, zamba2-1.2b, rwkv6-3b and whisper-large-v3 in
test_torch_train_families.py, which imports them from here (two files, so
that neither holds a worker for long: XLA's compiles dominate).

The reference's ``init`` parameters (every norm scale and bias, the SSM
biases and zamba2's LoRA ``b`` perturbed, so that none is a no-op) and the
same batch (labels with ignored positions) cross over as numpy arrays:

* ``loss``, its metrics and the gradient of every parameter leaf under
  remat against ``jax.value_and_grad`` of the reference's ``loss``;
* one ``make_train_step`` (``grad_accum`` 2, remat off, and for qwen3 also
  ``grad_accum`` 1 with remat on): every parameter, ``m``, ``v``, the
  step and the metrics against the reference's jitted step.

fp32 compute throughout. Tolerances: the loss and metrics to 1e-5 ·
max(1, |value|); a gradient, ``m`` and ``v`` leaf to δ = 1e-5 · max(1e-3,
max |leaf|) of the reference's leaf plus 1e-6 · max(1, max |leaf| over the
tree) (absolute). A parameter after the step to 1e-5 · max(1, max |p|) of
its leaf, plus what the gradient's own tolerance moves Adam's first step:
that step is lr · g / (|g| + eps) (``m̂ = g``, ``v̂ = g²``), which a change
δ_g of g moves by at most min(2, 2 δ_g / (|g| + eps)) — an element whose
gradient is near 0 may take either sign, in the reference's arithmetic as
much as the port's. g and δ_g are read from the reference's ``m`` and its
tolerance (m = (1 − b1) · g after one step).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as J  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.optim import adamw_init as j_adamw_init  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch import tree as TT  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.state import lm_params_from_numpy, opt_state_from_numpy  # noqa: E402

pytestmark = pytest.mark.torch

ARCHS = ("qwen3-1.7b", "starcoder2-15b", "paligemma-3b", "qwen2-moe-a2.7b")
B, T = 4, 16
PERTURBED = {"scale": 1.0, "ln_x_scale": 1.0, "d_skip": 1.0, "bias": 0.0, "bq": 0.0,
             "bk": 0.0, "bv": 0.0, "b": 0.0, "conv_b": 0.0, "dt_bias": 0.0, "ln_x_bias": 0.0}
#: a schedule whose first step moves the parameters visibly
TRAIN = dict(lr=1e-2, warmup=2, total_steps=10, compute_dtype="float32")
#: XLA's compile dominates this file's time; the reference's programs are
#: compiled with its backend optimizations off (the same operations, about
#: half the compile time)
QUICK_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _jit(fn):
    return jax.jit(fn, compiler_options=QUICK_COMPILE)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_params(cfg):
    """The reference's init (jitted: eager init takes seconds), as numpy
    arrays, with the PERTURBED leaves moved around their init value."""
    api = JR.build(cfg, compute_dtype=jnp.float32, remat=False)
    params = jax.tree.map(np.asarray, _jit(api.init)(jax.random.key(0)))
    rng = np.random.default_rng(11)

    def perturb(path, leaf):
        name = str(getattr(path[-1], "key", ""))
        if name not in PERTURBED:
            return leaf
        noise = rng.normal(size=leaf.shape).astype(np.float32)
        return (leaf + 0.1 * noise).astype(leaf.dtype)

    return jax.tree_util.tree_map_with_path(perturb, params)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    labels[0, :3] = -1  # ignored positions
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, T)).astype(np.int32), "labels": labels}
    if cfg.vis_ctx:
        batch["vis"] = (rng.normal(size=(B, cfg.vis_ctx, cfg.vis_width)) * 0.1).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = (rng.normal(size=(B, cfg.enc_ctx, cfg.d_model)) * 0.1).astype(
            np.float32)
    return batch


def _leaves_np(cfg, tree):
    """A reference tree of the parameters' structure → the port's leaves."""
    return [t.detach().numpy() for t in TT.leaves(lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, tree), device="cpu"))]


def _close_scalar(got, want, what):
    got = float(got.detach()) if isinstance(got, torch.Tensor) else float(got)
    want = float(want)
    assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), f"{what}: {got} against {want}"


def _leaf_tols(want, floor=1e-3) -> list[float]:
    """δ of each leaf (the module docstring)."""
    gmax = max(1.0, max(float(np.abs(w).max()) for w in want))
    return [1e-5 * max(floor, float(np.abs(w).max())) + 1e-6 * gmax for w in want]


def _close_leaves(got, want, what):
    assert len(got) == len(want), what
    for i, (g, w, tol) in enumerate(zip(got, want, _leaf_tols(want))):
        np.testing.assert_allclose(np.asarray(g, np.float32), w, rtol=0, atol=tol,
                                   err_msg=f"{what} leaf {i}")


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """(reference config, port config, the reference's parameters as numpy
    arrays, the batch), once an arch (the tests only read them)."""
    jcfg, tcfg = J.ARCHS[arch].reduced(), TC.ARCHS[arch].reduced()
    return jcfg, tcfg, _jax_params(jcfg), _batch(jcfg)


def check_loss_and_grads(arch):
    """``loss``, its metrics and every gradient leaf under remat."""
    jcfg, tcfg, jp, batch = _setup(arch)
    japi = JR.build(jcfg, compute_dtype=jnp.float32, remat=True)
    (jl, jm), jg = _jit(jax.value_and_grad(japi.loss, has_aux=True))(
        jax.tree.map(jnp.asarray, jp), jax.tree.map(jnp.asarray, batch))

    api = TR.build(tcfg, compute_dtype=torch.float32, remat=True, device="cpu")
    params = lm_params_from_numpy(tcfg, jp, device="cpu")
    params.requires_grad_(True)
    loss, metrics = api.loss(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, TT.leaves(params), allow_unused=True,
                                materialize_grads=True)
    _close_scalar(loss, jl, f"{arch} loss")
    for k in ("ce", "aux"):
        _close_scalar(metrics[k], jm[k], f"{arch} {k}")
    _close_leaves([g.numpy() for g in grads], _leaves_np(jcfg, jg), f"{arch} grad")


def check_train_step(arch, accum, remat):
    """One ``make_train_step``: every parameter, ``m``, ``v``, the step and
    the metrics."""
    jcfg, tcfg, jp, batch = _setup(arch)
    j_tc = J.TrainConfig(grad_accum=accum, remat=remat, **TRAIN)
    jpj = jax.tree.map(jnp.asarray, jp)
    jp2, jopt2, jmet = _jit(JR.make_train_step(jcfg, j_tc))(
        jpj, j_adamw_init(jpj), jax.tree.map(jnp.asarray, batch))

    params = lm_params_from_numpy(tcfg, jp, device="cpu")
    opt = adamw_init(params)
    step = TR.make_train_step(tcfg, TC.TrainConfig(grad_accum=accum, remat=remat, **TRAIN),
                              device="cpu")
    params, opt, met = step(params, opt, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert sorted(met) == sorted(jmet)
    for k in met:
        _close_scalar(met[k], jmet[k], f"{arch} {k}")
    assert int(opt["step"]) == int(jopt2["step"]) == 1
    want = opt_state_from_numpy(tcfg, jax.tree.map(np.asarray, jopt2), device="cpu")
    for name in ("m", "v"):
        _close_leaves([t.numpy() for t in TT.leaves(opt[name])],
                      [t.numpy() for t in TT.leaves(want[name])], f"{arch} {name}")
    m_ref = [t.numpy() for t in TT.leaves(want["m"])]
    got = [t.detach().numpy() for t in TT.leaves(params)]
    for i, (g, w, m, tol_m) in enumerate(zip(got, _leaves_np(jcfg, jp2), m_ref,
                                             _leaf_tols(m_ref))):
        grad, d_grad = np.abs(m) / 0.1, tol_m / 0.1  # b1 = 0.9
        tol = 1e-5 * max(1.0, float(np.abs(w).max())) \
            + TRAIN["lr"] / TRAIN["warmup"] * np.minimum(2.0, 2 * d_grad / (grad + 1e-8))
        assert np.all(np.abs(g - w) <= tol), f"{arch} param leaf {i}: {np.abs(g - w).max()}"


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads(arch):
    check_loss_and_grads(arch)


@pytest.mark.parametrize("arch,accum,remat", [(a, 2, False) for a in ARCHS]
                         + [("qwen3-1.7b", 1, True)])
def test_train_step(arch, accum, remat):
    check_train_step(arch, accum, remat)
