"""The port's LM building blocks (``repro_torch.configs``,
``repro_torch.models``) against the JAX package's, on the CPU.

* every ``ARCHS`` entry and its ``reduced()`` equal to the reference's,
  field by field, with ``head_dim``, ``padded_vocab``, ``SHAPES``,
  ``TrainConfig`` and ``supports_cell``;
* ``rmsnorm``, ``layernorm``, each ``act_fn``, ``mlp`` (gated and plain),
  ``apply_rope`` (θ = 1e4 and 1e6), ``unembed`` and the dense masks;
* ``flash_attention`` against the JAX one and against the port's own
  ``sdpa_ref`` on the four cases of tests/test_models.py's flash oracle
  plus dv ≠ dk, under both values of ``FLASH_BF16``;
* ``gqa_forward`` and ``gqa_decode`` with qkv bias, qk-norm, MQA (kv = 1)
  and MHA;
* ``build`` of a family not yet ported raises ``NotImplementedError``.

Inputs are seeded numpy arrays; parameters are random numpy trees (biases
and norm scales included, so that no term is a no-op). fp32 tolerances
are a few fp32 ulps of the values compared; where bf16 rounds an
intermediate, the tolerance is stated beside the check.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as J  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import flash as JF  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import perf_flags as JP  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro_torch import configs as T  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import flash as TF  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import perf_flags as TP  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402

pytestmark = pytest.mark.torch

ALL_ARCHS = sorted(J.ARCHS)
ATTN_MLP = ("qwen3-1.7b", "qwen2-1.5b", "stablelm-3b", "starcoder2-15b", "paligemma-3b")
UNPORTED = sorted(set(ALL_ARCHS) - set(ATTN_MLP))
F32_ATOL = 2e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


# ----------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_config_and_reduced_equal_the_reference(arch):
    for got, want in ((T.ARCHS[arch], J.ARCHS[arch]),
                      (T.ARCHS[arch].reduced(), J.ARCHS[arch].reduced())):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert (got.head_dim, got.padded_vocab) == (want.head_dim, want.padded_vocab)
    for cell in J.SHAPES.values():
        assert TR.supports_cell(T.ARCHS[arch], T.SHAPES[cell.name]) == \
            JR.supports_cell(J.ARCHS[arch], cell)


def test_shapes_and_train_config_equal_the_reference():
    assert {k: dataclasses.asdict(v) for k, v in T.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in J.SHAPES.items()}
    assert dataclasses.asdict(T.TrainConfig()) == dataclasses.asdict(J.TrainConfig())
    assert T.ARCHS["qwen3-1.7b"].padded_vocab == 152064


@pytest.mark.parametrize("arch", UNPORTED)
def test_unported_family_raises(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP item 14a-i"):
        TR.build(T.ARCHS[arch].reduced(), device="cpu")


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3 + 0.5
    scale = rng.normal(size=(64,)).astype(np.float32)
    bias = rng.normal(size=(64,)).astype(np.float32)
    tx = _t(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(dtype)
    got = TL.rmsnorm({"scale": _t(scale)}, tx, 1e-6)
    want = JL.rmsnorm({"scale": jnp.asarray(scale)}, jx, 1e-6)
    got_ln = TL.layernorm({"scale": _t(scale), "bias": _t(bias)}, tx, 1e-5)
    want_ln = JL.layernorm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}, jx, 1e-5)
    assert got.dtype == tx.dtype and got_ln.dtype == tx.dtype
    # fp32: a few ulps of values ~5; bf16 outputs: at most one bf16 ulp apart
    tol = dict(atol=1e-5, rtol=1e-6) if dtype == "float32" else dict(atol=0, rtol=2 ** -7)
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    np.testing.assert_allclose(_np(got_ln), _np(want_ln), **tol)


@pytest.mark.parametrize("name", ["silu", "gelu", "gelu_pytorch_tanh", "relu"])
def test_act_fn_matches(name):
    x = np.random.default_rng(1).normal(size=(4, 257)).astype(np.float32) * 4
    np.testing.assert_allclose(TL.act_fn(name)(_t(x)).numpy(),
                               np.asarray(JL.act_fn(name)(jnp.asarray(x))), atol=F32_ATOL,
                               rtol=1e-6)


@pytest.mark.parametrize("gated,act", [(True, "silu"), (False, "gelu_pytorch_tanh"),
                                       (True, "gelu"), (False, "relu")])
def test_mlp_matches(gated, act):
    rng = np.random.default_rng(2)
    p = {"w_up": rng.normal(size=(32, 48)) / 6, "w_down": rng.normal(size=(48, 32)) / 7}
    if gated:
        p["w_gate"] = rng.normal(size=(32, 48)) / 6
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(size=(2, 7, 32)).astype(np.float32)
    got = TL.mlp({k: _t(v) for k, v in p.items()}, _t(x), act)
    want = JL.mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("offset", [0, 4000])
def test_apply_rope_matches(theta, offset):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 16, 4, 32)).astype(np.float32)
    pos = (np.arange(16)[None].repeat(2, 0) + offset).astype(np.int32)
    np.testing.assert_array_equal(TL.rope_freqs(32, theta, device="cpu").numpy(),
                                  np.asarray(JL.rope_freqs(32, theta)))
    got = TL.apply_rope(_t(x), _t(pos), theta)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_ATOL)
    got16 = TL.apply_rope(_t(x).bfloat16(), _t(pos), theta)
    assert got16.dtype == torch.bfloat16


def test_unembed_and_masks_match():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 3, 16)).astype(np.float32)
    table = rng.normal(size=(40, 16)).astype(np.float32)
    for cd, jcd in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = TL.unembed(_t(x), _t(table), cd)
        want = JL.unembed(jnp.asarray(x), jnp.asarray(table), jcd)
        assert got.dtype == torch.float32
        # bf16: products rounded to bf16 in both, one bf16 ulp of ~4
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5 if cd == torch.float32 else 2 ** -5)
    np.testing.assert_array_equal(TA.causal_mask(2, 9, device="cpu").numpy(),
                                  np.asarray(JA.causal_mask(2, 9)))
    np.testing.assert_array_equal(TA.prefix_lm_mask(2, 9, 4, device="cpu").numpy(),
                                  np.asarray(JA.prefix_lm_mask(2, 9, 4)))


# ------------------------------------------------------------------- flash
FLASH_CASES = [
    # tests/test_models.py's flash oracle grid (b, tq, tk, kv, g, dh, dv, kind, prefix, bk)
    (2, 64, 64, 2, 3, 16, 16, "causal", 0, 16),
    (2, 48, 48, 1, 4, 8, 8, "prefix", 7, 32),
    (1, 33, 50, 2, 2, 8, 8, "none", 0, 16),
    (2, 128, 128, 4, 1, 32, 32, "causal", 0, 512),
    # dv != dk (test_flash_mla_different_dv's shape)
    (2, 32, 32, 4, 1, 24, 16, "causal", 0, 16),
]


@pytest.fixture
def flash_bf16(request, monkeypatch):
    monkeypatch.setattr(JP, "FLASH_BF16", request.param)
    monkeypatch.setattr(TP, "FLASH_BF16", request.param)
    return request.param


@pytest.mark.parametrize("flash_bf16", [False, True], indirect=True)
@pytest.mark.parametrize("b,tq,tk,kv,g,dh,dv,kind,prefix,bk", FLASH_CASES)
def test_flash_matches_jax_and_dense(flash_bf16, b, tq, tk, kv, g, dh, dv, kind, prefix, bk):
    rng = np.random.default_rng(5)
    q = rng.normal(size=(b, tq, kv, g, dh)).astype(np.float32)
    k = rng.normal(size=(b, tk, kv, dh)).astype(np.float32)
    v = rng.normal(size=(b, tk, kv, dv)).astype(np.float32)
    got = TF.flash_attention(_t(q), _t(k), _t(v), dh ** -0.5, kind, prefix, bk)
    assert got.shape == (b, tq, kv, g, dv) and got.dtype == torch.float32
    # a new function to jit each call: FLASH_BF16 is read while tracing
    want = jax.jit(lambda *a: JF.flash_attention(*a, dh ** -0.5, kind, prefix, bk))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    dense = TF.sdpa_ref(_t(q), _t(k), _t(v), dh ** -0.5, kind, prefix)
    np.testing.assert_allclose(dense.numpy(), np.asarray(jax.jit(
        JF.sdpa_ref, static_argnums=(3, 4, 5))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                                dh ** -0.5, kind, prefix)), atol=1e-6)
    if not flash_bf16:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
        np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=1e-5)
    else:
        # both round the same fp32 operands to bf16; a probability p may
        # round the other way at a tie of its fp32 value: one bf16 ulp of p·v
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)
        # bf16 operands against the fp32 oracle: ~2^-8 relative on logits
        np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=2e-2)


def test_flash_keeps_the_input_dtype():
    rng = np.random.default_rng(6)
    q = _t(rng.normal(size=(1, 8, 1, 2, 8)).astype(np.float32)).bfloat16()
    k = _t(rng.normal(size=(1, 8, 1, 8)).astype(np.float32)).bfloat16()
    out = TF.flash_attention(q, k, k, 8 ** -0.5, "causal", 0, 4)
    assert out.dtype == torch.bfloat16 and out.shape == (1, 8, 1, 2, 8)


# --------------------------------------------------------------- attention
GQA_CASES = {
    "qkv_bias": dict(arch="qwen2-1.5b", n_kv=2),
    "qk_norm": dict(arch="qwen3-1.7b", n_kv=2),
    "mqa": dict(arch="paligemma-3b", n_kv=1),
    "mha": dict(arch="stablelm-3b", n_kv=4),
}


def _gqa_params(cfg, rng):
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    p = {"wq": rng.normal(size=(d, h, dh)) * d ** -0.5,
         "wk": rng.normal(size=(d, kv, dh)) * d ** -0.5,
         "wv": rng.normal(size=(d, kv, dh)) * d ** -0.5,
         "wo": rng.normal(size=(h, dh, d)) * (h * dh) ** -0.5}
    if cfg.qkv_bias:
        p.update(bq=rng.normal(size=(h, dh)) * 0.1, bk=rng.normal(size=(kv, dh)) * 0.1,
                 bv=rng.normal(size=(kv, dh)) * 0.1)
    p = {k: v.astype(np.float32) for k, v in p.items()}
    if cfg.qk_norm:
        p["q_norm"] = {"scale": (1 + 0.2 * rng.normal(size=(dh,))).astype(np.float32)}
        p["k_norm"] = {"scale": (1 + 0.2 * rng.normal(size=(dh,))).astype(np.float32)}
    return p


def _tree(p, conv):
    return {k: _tree(v, conv) if isinstance(v, dict) else conv(v) for k, v in p.items()}


@pytest.mark.parametrize("case", sorted(GQA_CASES))
def test_gqa_forward_and_decode_match(case):
    spec = GQA_CASES[case]
    tcfg = T.ARCHS[spec["arch"]].reduced(n_kv=spec["n_kv"])
    jcfg = J.ARCHS[spec["arch"]].reduced(n_kv=spec["n_kv"])
    assert tcfg.qkv_bias == (case == "qkv_bias") and tcfg.qk_norm == (case == "qk_norm")
    assert tcfg.n_kv == {"mqa": 1, "mha": tcfg.n_heads}.get(case, tcfg.n_kv)
    rng = np.random.default_rng(7)
    p = _gqa_params(tcfg, rng)
    tp, jp = _tree(p, _t), _tree(p, jnp.asarray)
    b, t, t_max = 2, 12, 20
    x = rng.normal(size=(b, t, tcfg.d_model)).astype(np.float32)
    pos = np.arange(t, dtype=np.int32)[None].repeat(b, 0)
    mask = ("prefix", 5) if case == "mqa" else ("causal", 0)
    got, (gk, gv) = TA.gqa_forward(tp, tcfg, _t(x), _t(pos), mask)
    want, (wk, wv) = jax.jit(JA.gqa_forward, static_argnums=(1, 4))(
        jp, jcfg, jnp.asarray(x), jnp.asarray(pos), mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), atol=1e-5)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=1e-5)

    # decode three tokens against a bf16 cache holding the prefix's k/v
    jc = JA.gqa_cache_init(jcfg, b, t_max, jnp.bfloat16)
    jc = {"k": jc["k"].at[:, :t].set(wk.astype(jnp.bfloat16)),
          "v": jc["v"].at[:, :t].set(wv.astype(jnp.bfloat16)), "len": jnp.asarray(t, jnp.int32)}
    tc = {"k": _t(np.asarray(jc["k"].astype(jnp.float32))).bfloat16(),
          "v": _t(np.asarray(jc["v"].astype(jnp.float32))).bfloat16(),
          "len": torch.tensor(t, dtype=torch.int32)}
    decode = jax.jit(JA.gqa_decode, static_argnums=(1,))
    for step in range(3):
        x1 = rng.normal(size=(b, 1, tcfg.d_model)).astype(np.float32)
        got, tc = TA.gqa_decode(tp, tcfg, _t(x1), tc)
        want, jc = decode(jp, jcfg, jnp.asarray(x1), jc)
        assert got.dtype == torch.float32 and int(tc["len"]) == int(jc["len"]) == t + step + 1
        # the weights are cast to bf16 before the PV product in both
        # (attention.py:62-64): a weight at a rounding tie may round the
        # other way, one bf16 ulp of one term
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
        for name in ("k", "v"):
            np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), rtol=2 ** -7, atol=0)
