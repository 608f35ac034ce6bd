"""The port's Whisper (``models/whisper.py``, cross-attention in
``models/attention.py``) against the JAX package's, on the CPU, on the
reduced whisper-large-v3 config (2 + 2 layers, d_model 128, enc_ctx 32)
in fp32 compute, the reference's ``whisper_init`` parameters (norm scales
and biases perturbed) carried over by ``state.lm_params_from_numpy``:

* ``cross_init``'s shapes, ``cross_kv`` and ``cross_forward``;
* ``encode`` and ``decode_train`` (the logits and the stacked self k/v);
* ``whisper_prefill`` and 3 greedy decode steps, with an fp32 and a bf16
  cache: the logits, the greedy tokens, every cache tensor and ``len``;
* ``whisper_loss`` (labels with ignored positions), and
  ``registry.build``'s audio API.

Tolerances: activations, logits and fp32-cache steps to 1e-5 · max(1,
max |y|); the bf16 cache's tensors to one bf16 ulp (rtol 2^-7, atol 2e-6)
and its decode steps to 1e-3 · max(1, max |logit|) with equal greedy
tokens, as ``tests/test_torch_lm_serve.py`` holds bf16-cache decode (the
attention weights are cast to the cache's bf16 before the PV product, so
fp32 sums that differ in the last bits can round to neighbouring bf16
values). The self k/v that those bf16-cache decode steps write are
computed downstream of such a rounding, so after the steps the cache is
held to one bf16 ulp plus the logits' 1e-3 · max(1, max |value|), as
``tests/test_torch_lm_serve.py`` holds values downstream of a parted
rounding. The loss to 1e-5 · max(1, |loss|).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as J  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.models import whisper as JW  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch import tree as TT  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models import whisper as TW  # noqa: E402
from repro_torch.state import lm_params_from_numpy  # noqa: E402

pytestmark = pytest.mark.torch

ARCH = "whisper-large-v3"
B, T_PROMPT, T_MAX, STEPS = 2, 8, 16, 3
CACHE_TOL = dict(rtol=2 ** -7, atol=2e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, what, scale=1e-5):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, f"{what}: {got.shape} against {want.shape}"
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=scale * max(1.0, float(np.abs(want).max())), err_msg=what)


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = J.ARCHS[ARCH].reduced(), TC.ARCHS[ARCH].reduced()
    params = jax.jit(JR.build(jcfg, compute_dtype=jnp.float32, remat=False).init)(
        jax.random.key(0))
    rng = np.random.default_rng(5)

    def perturb(path, leaf):
        name = str(getattr(path[-1], "key", ""))
        if name not in ("scale", "bias"):
            return leaf
        return leaf + jnp.asarray(0.1 * rng.normal(size=leaf.shape), leaf.dtype)

    params = jax.tree_util.tree_map_with_path(perturb, params)
    ported = lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, params), device="cpu")
    rng = np.random.default_rng(0)
    frames = (rng.normal(size=(B, jcfg.enc_ctx, jcfg.d_model)) * 0.1).astype(np.float32)
    tokens = rng.integers(0, jcfg.vocab, (B, T_PROMPT)).astype(np.int32)
    return jcfg, tcfg, params, ported, frames, tokens


def test_cross_attention(model):
    jcfg, tcfg, params, ported, frames, tokens = model
    gen = torch.Generator().manual_seed(0)
    fresh = TA.cross_init(gen, tcfg, torch.float32)
    want = JA.cross_init(jax.random.key(1), jcfg, jnp.float32)
    assert {k: tuple(v.shape) for k, v in fresh.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    jp, tp = params["dec_blocks"]["cross"], ported["dec_blocks"][1]["cross"]
    jp = jax.tree.map(lambda a: a[1], jp)
    rng = np.random.default_rng(1)
    enc = rng.normal(size=(B, jcfg.enc_ctx, jcfg.d_model)).astype(np.float32)
    x = rng.normal(size=(B, 5, jcfg.d_model)).astype(np.float32)
    jk, jv = JA.cross_kv(jp, jnp.asarray(enc))
    tk, tv = TA.cross_kv(tp, torch.from_numpy(enc))
    _close(tk, jk, "cross k")
    _close(tv, jv, "cross v")
    _close(TA.cross_forward(tp, tcfg, torch.from_numpy(x), tk, tv),
           JA.cross_forward(jp, jcfg, jnp.asarray(x), jk, jv), "cross_forward")


def test_encode_and_decode_train(model):
    jcfg, tcfg, params, ported, frames, tokens = model
    enc = JW.encode(params, jcfg, jnp.asarray(frames), jnp.float32, remat=False)
    got = TW.encode(ported, tcfg, torch.from_numpy(frames), torch.float32, remat=False)
    _close(got, enc, "encode")
    logits, (k, v) = JW.decode_train(params, jcfg, jnp.asarray(tokens), enc, jnp.float32,
                                     remat=False)
    tl, (tk, tv) = TW.decode_train(ported, tcfg, torch.from_numpy(tokens),
                                   torch.from_numpy(np.array(enc)), torch.float32, remat=False)
    _close(tl, logits, "decode_train logits")
    _close(tk, k, "decode_train self k")
    _close(tv, v, "decode_train self v")


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_prefill_and_decode(model, cache_dtype):
    jcfg, tcfg, params, ported, frames, tokens = model
    jdt, tdt = getattr(jnp, cache_dtype), getattr(torch, cache_dtype)
    batch = {"tokens": jnp.asarray(tokens), "frames": jnp.asarray(frames)}
    logits, cache = jax.jit(lambda p, b: JW.whisper_prefill(p, jcfg, b, T_MAX, jnp.float32,
                                                            jdt))(params, batch)
    tl, tcache = TW.whisper_prefill(ported, tcfg, {k: torch.from_numpy(np.array(v))
                                                   for k, v in batch.items()},
                                    T_MAX, torch.float32, tdt)
    _close(tl, logits, "prefill logits")

    def cache_close(what, drift=0.0):
        assert int(tcache["len"]) == int(cache["len"]), what
        pairs = [(tcache["self"]["k"], cache["self"]["k"], "self k"),
                 (tcache["self"]["v"], cache["self"]["v"], "self v"),
                 (tcache["cross_k"], cache["cross_k"], "cross k"),
                 (tcache["cross_v"], cache["cross_v"], "cross v")]
        for got, want, name in pairs:
            assert got.dtype == tdt and tuple(got.shape) == want.shape, f"{what} {name}"
            top = max(1.0, float(jnp.abs(want.astype(jnp.float32)).max()))
            tol = (dict(rtol=CACHE_TOL["rtol"], atol=CACHE_TOL["atol"] + drift * top)
                   if cache_dtype == "bfloat16" else dict(rtol=0, atol=1e-5 * top))
            np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol,
                                       err_msg=f"{what} {name}")

    cache_close("prefill")
    decode = jax.jit(lambda p, b, c: JW.whisper_decode_step(p, jcfg, b, c, jnp.float32))
    scale = 1e-5 if cache_dtype == "float32" else 1e-3
    for step in range(STEPS):
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
        ttok = tl[:, -1].argmax(-1)[:, None].to(torch.int32)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(tok), f"step {step} tokens")
        logits, cache = decode(params, {"tokens": tok}, cache)
        tl, tcache = TW.whisper_decode_step(ported, tcfg, {"tokens": ttok}, tcache,
                                            torch.float32)
        _close(tl, logits, f"decode step {step}", scale)
    cache_close("after decode", drift=1e-3 if cache_dtype == "bfloat16" else 0.0)


def test_loss_and_build(model):
    jcfg, tcfg, params, ported, frames, tokens = model
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    batch = {"tokens": tokens, "labels": labels, "frames": frames}
    jl, jm = JW.whisper_loss(params, jcfg, jax.tree.map(jnp.asarray, batch), jnp.float32,
                             remat=False)
    api = TR.build(tcfg, compute_dtype=torch.float32, remat=True, device="cpu")
    tl, tm = api.loss(ported, {k: torch.from_numpy(v) for k, v in batch.items()})
    _close(tl, jl, "whisper_loss")
    _close(tm["ce"], jm["ce"], "ce")
    assert float(tm["aux"]) == 0.0
    fresh = api.init()
    assert isinstance(fresh, TW.Whisper)
    assert [tuple(t.shape) for t in TT.leaves(fresh)] == \
        [tuple(t.shape) for t in TT.leaves(ported)]
    cache = api.cache_init(B, T_MAX)
    want = JW.whisper_cache_init(jcfg, B, T_MAX)
    assert tuple(cache["self"]["k"].shape) == want["self"]["k"].shape
    assert tuple(cache["cross_k"].shape) == want["cross_k"].shape
    assert cache["cross_k"].dtype == torch.bfloat16
