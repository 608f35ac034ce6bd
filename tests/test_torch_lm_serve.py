"""The port's LM serving path against the JAX package's, on the CPU.

* the whole model on the reduced configs of the five attention-MLP archs
  in fp32, the reference's ``lm_init`` parameters (norm scales and biases
  perturbed, so that none is a no-op) carried over by
  ``state.lm_params_from_numpy``: the prefill's last logits, cache k/v and
  ``len``, then four decode steps' logits and greedy tokens, each step fed
  its own greedy token, with the default bf16 cache and with an fp32 one
  (``lm_prefill``'s ``cache_dtype``); the port's own prefill/decode
  consistency (the reference's ≤ 2e-2); the carrier's layouts and
  ``init``'s shapes;
* qwen3 in bf16 compute against the reference in bf16;
* ``TokenPipeline``'s chain handed the reference's draws;
* ``launch.serve``: ``generate`` on the reference's parameters and
  prompts gives the reference loop's tokens, and ``main`` prints the
  reference's lines.

The port cannot reproduce ``jax.random``, so parameters, prompts and
draws cross over as numpy arrays. fp32 logits: max |Δ| ≤ 1e-4 ·
max(1, max |logit|), the prefill's and every decode step's from an fp32
cache. With the bf16 cache, decode rounds the cached k/v and casts the
attention weights to bf16 before the PV product (attention.py:62-64): a
value whose fp32 sums differ in the last bits may round to the
neighbouring bf16 value in one package and not the other, so those steps
are held to 1e-3 · max(1, max |logit|) (starcoder2's first step differs
by 1.25e-4 at max |logit| ≈ 0.8) and to equal greedy tokens. Caches: one
bf16 ulp, or near 0 the fp32 error of the value rounded (CACHE_TOL).
"""
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as J  # noqa: E402
from repro.data import lm_tokens as JD  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro_torch import configs as T  # noqa: E402
from repro_torch.data import lm_tokens as TD  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.state import lm_params_from_numpy  # noqa: E402

pytestmark = pytest.mark.torch

ATTN_MLP = ("qwen3-1.7b", "qwen2-1.5b", "stablelm-3b", "starcoder2-15b", "paligemma-3b")
B, T_PROMPT, T_MAX, STEPS = 2, 16, 64, 4
PERTURBED = ("scale", "bias", "bq", "bk", "bv")
CACHE_TOL = dict(rtol=2 ** -7, atol=2e-6)


def _logit_tol(ref):
    return 1e-4 * max(1.0, float(np.abs(ref).max()))


def _jax_params(cfg, dtype=jnp.float32):
    """The reference's init with every norm scale and bias perturbed."""
    params = JR.build(cfg, compute_dtype=dtype, remat=False).init(jax.random.key(0))
    rng = np.random.default_rng(11)

    def perturb(path, leaf):
        name = str(getattr(path[-1], "key", ""))
        if name not in PERTURBED:
            return leaf
        base = 1.0 if name == "scale" else 0.0
        noise = rng.normal(size=leaf.shape).astype(np.float32)
        return jnp.asarray(base + 0.1 * noise, leaf.dtype) + (leaf - base)

    return jax.tree_util.tree_map_with_path(perturb, params)


def _inputs(cfg, b=B, t=T_PROMPT, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, t)).astype(np.int32)}
    if cfg.vis_ctx:
        batch["vis"] = (rng.normal(size=(b, cfg.vis_ctx, cfg.vis_width)) * 0.1).astype(np.float32)
    return batch


def _to_np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _reference_run(api, cfg, params, batch, cache_dtype):
    from repro.models import transformer as JT

    prefill = jax.jit(lambda p, b: JT.lm_prefill(p, cfg, b, T_MAX, jnp.float32, cache_dtype))
    decode = jax.jit(api.decode)
    logits, cache = prefill(params, jax.tree.map(jnp.asarray, batch))
    ref = {"prefill": _to_np(logits), "len": int(cache["len"]),
           "k": _to_np(cache["segments"][0]["k"]), "v": _to_np(cache["segments"][0]["v"]),
           "steps": [], "tokens": []}
    for _ in range(STEPS):
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
        ref["tokens"].append(np.asarray(tok))
        logits, cache = decode(params, {"tokens": tok}, cache)
        ref["steps"].append(_to_np(logits))
    ref["k_end"] = _to_np(cache["segments"][0]["k"])
    return ref


@pytest.fixture(scope="module", params=ATTN_MLP)
def served(request):
    """The reference's prefill and STEPS greedy decode steps on one arch,
    with a bf16 and an fp32 cache, and what the port needs to run the same."""
    arch = request.param
    cfg = J.ARCHS[arch].reduced()
    api = JR.build(cfg, compute_dtype=jnp.float32, remat=False)
    params = _jax_params(cfg)
    batch = _inputs(cfg)
    refs = {name: _reference_run(api, cfg, params, batch, dt)
            for name, dt in (("bfloat16", jnp.bfloat16), ("float32", jnp.float32))}
    return arch, jax.tree.map(np.asarray, params), batch, refs


def _port(arch, np_params, compute_dtype=torch.float32):
    cfg = T.ARCHS[arch].reduced()
    api = TR.build(cfg, compute_dtype=compute_dtype, device="cpu")
    return cfg, api, lm_params_from_numpy(cfg, np_params, device="cpu")


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_prefill(api, cfg, params, batch, cache_dtype):
    return TT.lm_prefill(params, cfg, _tensors(batch), T_MAX, torch.float32,
                         getattr(torch, cache_dtype))


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "float32"])
def test_prefill_matches(served, cache_dtype):
    arch, np_params, batch, refs = served
    ref = refs[cache_dtype]
    cfg, api, params = _port(arch, np_params)
    logits, cache = _port_prefill(api, cfg, params, batch, cache_dtype)
    assert logits.shape == (B, 1, cfg.padded_vocab) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), ref["prefill"], atol=_logit_tol(ref["prefill"]))
    assert int(cache["len"]) == ref["len"] == T_PROMPT + cfg.vis_ctx
    for name in ("k", "v"):
        got = cache["segments"][0][name]
        assert str(got.dtype) == f"torch.{cache_dtype}" and got.shape == ref[name].shape
        np.testing.assert_allclose(got.float().numpy(), ref[name], **CACHE_TOL)
    if cache_dtype == "bfloat16":  # the registry's prefill: the serving default
        got, _ = api.prefill(params, _tensors(batch), T_MAX)
        assert torch.equal(got, logits)


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "float32"])
def test_decode_steps_match(served, cache_dtype):
    arch, np_params, batch, refs = served
    ref = refs[cache_dtype]
    scale = 1e-3 if cache_dtype == "bfloat16" else 1e-4  # the module docstring says why
    cfg, api, params = _port(arch, np_params)
    logits, cache = _port_prefill(api, cfg, params, batch, cache_dtype)
    for step in range(STEPS):
        tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        np.testing.assert_array_equal(tok.numpy(), ref["tokens"][step])
        logits, cache = api.decode(params, {"tokens": tok}, cache)
        want = ref["steps"][step]
        assert int(cache["len"]) == ref["len"] + step + 1
        np.testing.assert_allclose(logits.numpy(), want,
                                   atol=scale * max(1.0, float(np.abs(want).max())),
                                   err_msg=f"{arch} decode step {step}")
    np.testing.assert_allclose(cache["segments"][0]["k"].float().numpy(), ref["k_end"],
                               **CACHE_TOL)


def test_prefill_decode_consistency(served):
    """The reference's own check (tests/test_models.py), on the port: one
    decode step after a prefill of T equals the prefill of T + 1."""
    arch, np_params, batch, _ = served
    cfg, api, params = _port(arch, np_params)
    tb = _tensors(batch)
    _, cache = api.prefill(params, tb, T_MAX)
    nxt = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (B, 1)).astype(
        np.int32))
    dec, _ = api.decode(params, {"tokens": nxt}, cache)
    full, _ = api.prefill(params, {**tb, "tokens": torch.cat([tb["tokens"], nxt], 1)}, T_MAX)
    assert float((full[:, -1] - dec[:, -1]).abs().max()) < 2e-2
    assert bool(torch.isfinite(dec).all())


def test_carrier_and_init_layouts(served):
    arch, np_params, _, _ = served
    cfg, api, params = _port(arch, np_params)
    segs = params["segments"]
    assert [len(s) for s in segs] == [s.count for s in TT.program(cfg)]
    for name, leaf in jax.tree_util.tree_flatten_with_path(np_params["segments"][0])[0]:
        keys = [str(k.key) for k in name]
        for i in range(len(segs[0])):
            got = segs[0][i]
            for key in keys:
                got = got[key]
            np.testing.assert_array_equal(got.numpy(), leaf[i])
    np.testing.assert_array_equal(params["embed"].numpy(), np_params["embed"])
    init = api.init()
    shapes = {n: tuple(p.shape) for n, p in init.named_parameters()}
    assert shapes == {n: tuple(p.shape) for n, p in params.named_parameters()}
    assert all(p.dtype == torch.float32 and not p.requires_grad for p in init.parameters())
    with pytest.raises(ValueError, match="segments"):
        lm_params_from_numpy(cfg, {**np_params, "segments": []}, device="cpu")
    one_layer = jax.tree.map(lambda a: a[:1], np_params["segments"][0])
    with pytest.raises(ValueError, match="stacks"):
        lm_params_from_numpy(cfg, {**np_params, "segments": [one_layer]}, device="cpu")


def test_bf16_compute_matches():
    """qwen3 in bf16 compute (fp32 parameters cast at each use) against the
    reference in bf16, the reference's tokens fed to both. Bound: four bf16
    ulps of max(1, max |logit|), 2^-6: the logits are rounded to bf16
    before their fp32 cast, and every product before them."""
    cfg = J.ARCHS["qwen3-1.7b"].reduced()
    api = JR.build(cfg, compute_dtype=jnp.bfloat16, remat=False)
    params = _jax_params(cfg)
    batch = _inputs(cfg)
    logits, cache = api.prefill(params, jax.tree.map(jnp.asarray, batch), T_MAX)
    tcfg, tapi, tparams = _port("qwen3-1.7b", jax.tree.map(np.asarray, params), torch.bfloat16)
    tlogits, tcache = tapi.prefill(tparams, _tensors(batch), T_MAX)
    decode = jax.jit(api.decode)
    for step in range(3):
        want = _to_np(logits)
        np.testing.assert_allclose(tlogits.numpy(), want,
                                   atol=2 ** -6 * max(1.0, float(np.abs(want).max())))
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
        logits, cache = decode(params, {"tokens": tok}, cache)
        tlogits, tcache = tapi.decode(tparams, {"tokens": torch.from_numpy(np.array(tok))},
                                      tcache)


def test_reference_lm_path_holds_no_pallas_call():
    """The analysis table's lm_prefill / lm_decode rows declare 0 hand
    kernels beside the reference's 0: its traced prefill and decode hold no
    pallas_call (attention is plain JAX, flash.py)."""
    cfg = J.ARCHS["qwen3-1.7b"].reduced()
    api = JR.build(cfg, compute_dtype=jnp.float32, remat=False)
    params = jax.eval_shape(api.init, jax.random.key(0))
    tokens = jax.ShapeDtypeStruct((2, 8), jnp.int32)
    pre = jax.make_jaxpr(lambda p, t: api.prefill(p, {"tokens": t}, 16))(params, tokens)
    cache = jax.eval_shape(lambda: api.cache_init(2, 16))
    dec = jax.make_jaxpr(lambda p, t, c: api.decode(p, {"tokens": t}, c))(
        params, jax.ShapeDtypeStruct((2, 1), jnp.int32), cache)
    assert "pallas_call" not in str(pre) and "pallas_call" not in str(dec)


# ------------------------------------------------------------------- data
def test_token_chain_given_the_reference_draws():
    pipe = JD.TokenPipeline(vocab=509, seq_len=24, global_batch=3, seed=5)
    for step in (0, 7):
        key = jax.random.fold_in(jax.random.key(5), step)
        k1, k2 = jax.random.split(key)
        first = np.asarray(jax.random.randint(k1, (3, 1), 0, 509))
        eps = np.asarray(jax.random.randint(k2, (3, 24), 0, 4))
        got = TD.chain(torch.tensor(first), torch.tensor(eps), 509)
        want = pipe.batch(step)
        for name in ("tokens", "labels"):
            assert got[name].dtype == torch.int32
            np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))


def test_token_pipeline_is_a_pure_function_of_seed_and_step():
    pipe = TD.TokenPipeline(vocab=1000, seq_len=32, global_batch=4, seed=3, device="cpu")
    a, b, c = pipe.batch(2), pipe.batch(2), pipe.batch(3)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["tokens"], c["tokens"])
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    nxt = (31 * a["tokens"].long() + 17) % 1000
    assert bool((((a["labels"].long() - nxt) % 1000) < pipe.noise).all())
    assert not torch.equal(a["tokens"],
                           TD.TokenPipeline(1000, 32, 4, seed=4, device="cpu").batch(2)["tokens"])


# ------------------------------------------------------------------ serve
def test_generate_gives_the_reference_loops_tokens():
    """launch.serve's loop on the reference's parameters and prompts, at
    the launcher's default shape under --reduced, against the reference
    launcher's loop (src/repro/launch/serve.py:41-62)."""
    cfg = J.ARCHS["qwen3-1.7b"].reduced()
    b, p_len, gen = 4, 32, 16
    api = JR.build(cfg, compute_dtype=jnp.float32, remat=False)
    params = api.init(jax.random.key(0))
    prompts = jax.random.randint(jax.random.key(1), (b, p_len), 0, cfg.vocab)
    t_max = p_len + gen
    logits, cache = jax.jit(lambda p, x: api.prefill(p, x, t_max))(params, {"tokens": prompts})
    decode = jax.jit(api.decode)
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
    want = [tok]
    for _ in range(gen - 1):
        logits, cache = decode(params, {"tokens": tok}, cache)
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
        want.append(tok)
    want = np.asarray(jnp.concatenate(want, axis=1))

    tcfg, tapi, tparams = _port("qwen3-1.7b", jax.tree.map(np.asarray, params))
    got, t_prefill, t_decode = TS.generate(
        tapi, tparams, {"tokens": torch.from_numpy(np.array(prompts))}, t_max, gen)
    assert got.shape == (b, gen) and got.dtype == torch.int32 and t_prefill > 0 < t_decode
    np.testing.assert_array_equal(got.numpy(), want)


def _shape_of(text):
    return [re.sub(r"\d+(\.\d+)?", "N", line) for line in text.strip().splitlines()]


def test_serve_main_prints_the_reference_lines(capsys, monkeypatch):
    from repro.launch import serve as JS

    monkeypatch.setattr(sys, "argv", ["serve", "--reduced"])
    JS.main()
    want = capsys.readouterr().out
    assert TS.main(["--reduced", "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert _shape_of(got) == _shape_of(want) and len(_shape_of(got)) == 4
    assert got.splitlines()[0] == "[serve] qwen3-1.7b (reduced)"
    assert TS.main(["--reduced", "--device", "cpu", "--arch", "paligemma-3b", "--gen", "3"]) == 0
    assert capsys.readouterr().out.splitlines()[0] == "[serve] paligemma-3b (reduced)"
    with pytest.raises(SystemExit, match="decoder-only archs"):
        TS.main(["--reduced", "--device", "cpu", "--arch", "whisper-large-v3"])
