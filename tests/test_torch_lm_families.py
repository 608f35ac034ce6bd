"""The port's MoE, MLA, Mamba2 and RWKV6 modules against the JAX package's,
on the CPU.

* ``moe_apply`` (its aux loss included) and the dense oracle ``moe_ref``
  against the reference under both values of its
  ``perf_flags.MOE_GATHER_DISPATCH`` (the port has one dispatch), on
  reduced qwen2-moe at the default capacity factor and at
  0.5 (drops certainly happen) and with 6 routed experts padded to 8 (the
  dead-expert mask): the selected experts and the dropped assignments
  equal the reference's, token by token;
* ``mla_forward`` and three absorbed ``mla_decode`` steps against a bf16
  and an fp32 compressed cache;
* ``mamba2_forward`` at T a whole number of chunks and not,
  ``mamba2_decode`` and ``mamba2_recurrent_ref``, and the reference's
  state-handoff check (tests/test_models.py:123);
* ``rwkv6_mix_chunked`` and ``rwkv6_mix_recurrent`` from a carried state
  and token shift, and ``rwkv6_cmix`` with its carry;
* a sequence shorter than the chunk: one chunk of its own length, as the
  reference's ``costmode.chunk_size`` gives outside cost mode.

Parameters are the reference's own inits (``jax.random``), carried as
numpy arrays, with every zero bias and unit scale perturbed so that no
term is a no-op. Tolerances are fp32: max |Δ| ≤ 1e-5 · max(1, max |y|)
for a module's output (the two packages sum in other orders), stated
beside each check where another applies.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as J  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import perf_flags as JP  # noqa: E402
from repro.models import rwkv6 as JRK  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro_torch import configs as T  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import rwkv6 as TRK  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402

pytestmark = pytest.mark.torch


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These runs are many small ops: with one intra-op thread a worker
    does not oversubscribe the cores it shares with the other test
    workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

#: leaves perturbed around their init (0 or 1), so that no bias, shift or
#: scale is a no-op
PERTURBED = {"scale": 1.0, "ln_x_scale": 1.0, "d_skip": 1.0, "conv_b": 0.0, "dt_bias": 0.0,
             "ln_x_bias": 0.0}


def _perturb(tree, seed=11):
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        base = PERTURBED.get(str(getattr(path[-1], "key", "")))
        x = np.asarray(x, np.float32)
        if base is None:
            return x
        return (x + 0.1 * rng.normal(size=x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(got, want, scale=1e-5, msg=""):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, atol=scale * max(1.0, float(np.abs(want).max())),
                               rtol=0, err_msg=msg)


def _x(shape, seed, scale=0.5):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------- MoE
MOE_CASES = {
    "default": dict(),
    "drops": dict(capacity_factor=0.5),
    "padded": dict(n_routed=6, n_padded=8),
}


def _moe_cfgs(case):
    out = []
    for pkg in (T, J):
        cfg = pkg.ARCHS["qwen2-moe-a2.7b"].reduced()
        out.append(dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **MOE_CASES[case])))
    return out


def _reference_routing(p, cfg, xf):
    """The reference's routing and slot plan (src/repro/models/moe.py:41-66)
    from its own router product, softmax and top_k: (probs, sel (N, k),
    kept (N, k))."""
    m = cfg.moe
    logits = (jnp.asarray(xf) @ jnp.asarray(p["router"])).astype(jnp.float32)
    if m.n_padded and m.n_padded > m.n_routed:
        logits = jnp.where(jnp.arange(m.padded) >= m.n_routed, -1e30, logits)
    probs = jax.nn.softmax(logits, axis=-1)
    _, sel = jax.lax.top_k(probs, m.top_k)
    sel = np.asarray(sel)
    n, k = sel.shape
    cap = int(max(8, (n * k / max(m.n_routed, 1)) * m.capacity_factor))
    flat = sel.reshape(-1)
    order = np.argsort(flat, kind="stable")
    counts = np.bincount(flat, minlength=m.padded)
    starts = np.cumsum(counts) - counts
    pos = np.arange(n * k) - starts[flat[order]]
    kept = np.empty(n * k, bool)
    kept[order] = pos < cap
    return np.asarray(probs), sel, kept.reshape(n, k)


@pytest.mark.parametrize("gather", [False, True])
@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_matches_the_reference(case, gather, monkeypatch):
    """The port's one dispatch (row writes) against the reference under
    either of its dispatch forms (``perf_flags.MOE_GATHER_DISPATCH``)."""
    tcfg, jcfg = _moe_cfgs(case)
    monkeypatch.setattr(JP, "MOE_GATHER_DISPATCH", gather)
    p = _perturb(JM.moe_init(jax.random.key(0), jcfg, jnp.float32))
    x = _x((2, 24, tcfg.d_model), 1)
    want, want_aux = jax.jit(JM.moe_apply, static_argnums=1)(_j(p), jcfg, jnp.asarray(x))
    got, aux = TM.moe_apply(_t(p), tcfg, _t(x))
    _close(got, want, msg=f"{case} gather={gather}")
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)

    # routing: the same experts for every token, the same assignments dropped
    xf = x.reshape(-1, tcfg.d_model)
    probs, sel, kept = _reference_routing(p, jcfg, xf)
    top = -np.sort(-probs, axis=-1)
    k = tcfg.moe.top_k
    gap = float((top[:, k - 1] - top[:, k]).min())
    print(f"{case}: smallest k-th/(k+1)-th probability gap {gap:.3e}")
    _, _, tsel = TM.route(_t(p), tcfg, _t(xf))
    np.testing.assert_array_equal(tsel.numpy(), sel)
    cap = TM.capacity(tcfg, xf.shape[0])
    order, _, _, keep, _ = TM.slots(tsel, tcfg.moe.padded, cap)
    tkept = np.empty(keep.numel(), bool)
    tkept[order.numpy()] = keep.numpy()
    np.testing.assert_array_equal(tkept.reshape(kept.shape), kept)
    assert (~kept).any() == (case == "drops"), f"{case}: {int((~kept).sum())} dropped"
    if case == "padded":  # dead experts are never selected
        assert (sel < tcfg.moe.n_routed).all()


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_ref_matches_the_reference(case):
    tcfg, jcfg = _moe_cfgs(case)
    p = _perturb(JM.moe_init(jax.random.key(2), jcfg, jnp.float32))
    x = _x((2, 16, tcfg.d_model), 3)
    want = jax.jit(JM.moe_ref, static_argnums=1)(_j(p), jcfg, jnp.asarray(x))
    _close(TM.moe_ref(_t(p), tcfg, _t(x)), want)
    # tests/test_models.py's dispatch check: at capacity factor 16 nothing
    # drops, and the dispatch equals the dense oracle
    wide = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, capacity_factor=16.0))
    got, _ = TM.moe_apply(_t(p), wide, _t(x))
    _close(got, want)


def test_moe_combine_is_one_fixed_order_sum():
    """The combine adds a token's rows one at a time in ascending expert
    order: bitwise equal to that loop written out, and repeatable."""
    tcfg, jcfg = _moe_cfgs("drops")
    p = _t(_perturb(JM.moe_init(jax.random.key(4), jcfg, jnp.float32)))
    x = _t(_x((3, 8, tcfg.d_model), 5)).bfloat16()
    a, _ = TM.moe_apply(p, tcfg, x)
    b, _ = TM.moe_apply(p, tcfg, x)
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    n, k = 24, tcfg.moe.top_k
    rows = torch.randn(n * k, 16).bfloat16()
    order = torch.randperm(n * k, generator=torch.Generator().manual_seed(0))
    want = torch.zeros(n, 16).bfloat16()
    for j in range(k):
        at = torch.sort(torch.argsort(order).reshape(n, k), dim=1).values[:, j]
        want = want + rows[at]
    assert torch.equal(TM._combine(rows, order, n, k), want)


# ---------------------------------------------------------------------- MLA
@pytest.mark.parametrize("cache_dtype", ["bfloat16", "float32"])
def test_mla_forward_and_decode_match(cache_dtype):
    tcfg, jcfg = T.ARCHS["deepseek-v2-236b"].reduced(), J.ARCHS["deepseek-v2-236b"].reduced()
    p = _perturb(JA.mla_init(jax.random.key(5), jcfg, jnp.float32))
    tp, jp = _t(p), _j(p)
    b, t, t_max = 2, 12, 20
    x = _x((b, t, tcfg.d_model), 6)
    pos = np.arange(t, dtype=np.int32)[None].repeat(b, 0)
    got, (gckv, gkpe) = TA.mla_forward(tp, tcfg, _t(x), _t(pos), ("causal", 0))
    want, (wckv, wkpe) = jax.jit(JA.mla_forward, static_argnums=(1, 4))(
        jp, jcfg, jnp.asarray(x), jnp.asarray(pos), ("causal", 0))
    _close(got, want)
    _close(gckv, wckv)
    _close(gkpe, wkpe)

    cdt = getattr(jnp, cache_dtype)
    jc = JA.mla_cache_init(jcfg, b, t_max, cdt)
    jc = {"ckv": jc["ckv"].at[:, :t].set(wckv.astype(cdt)),
          "kpe": jc["kpe"].at[:, :t].set(wkpe.astype(cdt)), "len": jnp.asarray(t, jnp.int32)}
    tc = {name: _t(np.asarray(jc[name].astype(jnp.float32))).to(getattr(torch, cache_dtype))
          for name in ("ckv", "kpe")}
    tc["len"] = torch.tensor(t, dtype=torch.int32)
    decode = jax.jit(JA.mla_decode, static_argnums=(1,))
    for step in range(3):
        x1 = _x((b, 1, tcfg.d_model), 10 + step)
        got, tc = TA.mla_decode(tp, tcfg, _t(x1), tc)
        want, jc = decode(jp, jcfg, jnp.asarray(x1), jc)
        assert int(tc["len"]) == int(jc["len"]) == t + step + 1
        assert tc["ckv"].dtype == getattr(torch, cache_dtype)
        _close(got, want, msg=f"decode step {step}")
        for name in ("ckv", "kpe"):  # bf16: one ulp of a value rounded
            np.testing.assert_allclose(tc[name].float().numpy(),
                                       np.asarray(jc[name].astype(jnp.float32)),
                                       rtol=2 ** -7, atol=2e-6)


# ------------------------------------------------------------------- Mamba2
def _mamba(seed):
    tcfg, jcfg = T.ARCHS["zamba2-1.2b"].reduced(), J.ARCHS["zamba2-1.2b"].reduced()
    p = _perturb(JS.mamba2_init(jax.random.key(seed), jcfg, jnp.float32))
    return tcfg, jcfg, p


@pytest.mark.parametrize("t", [32, 40])
def test_mamba2_forward_decode_and_oracle_match(t):
    """T = 32 is two chunks of 16, T = 40 is padded to 48. The chunked form
    equals the recurrence to the reference's own 1e-4 (test_models.py)."""
    tcfg, jcfg, p = _mamba(1)
    tp = _t(p)
    x = _x((2, t, tcfg.d_model), 2)
    got, (gconv, gssm) = TS.mamba2_forward(tp, tcfg, _t(x))
    want, (wconv, wssm) = jax.jit(JS.mamba2_forward, static_argnums=1)(_j(p), jcfg, jnp.asarray(x))
    _close(got, want)
    _close(gconv, wconv)
    _close(gssm, wssm)
    rec, (rconv, rssm) = TS.mamba2_recurrent_ref(tp, tcfg, _t(x))
    wrec, (wrconv, wrssm) = JS.mamba2_recurrent_ref(_j(p), jcfg, jnp.asarray(x))
    _close(rec, wrec)
    _close(rssm, wrssm)
    _close(rconv, wrconv)
    np.testing.assert_allclose(got.numpy(), rec.numpy(), atol=1e-4)
    np.testing.assert_allclose(gssm.numpy(), rssm.numpy(), atol=1e-4)

    # decode two tokens from the prefill's states, a bf16 window as
    # lm_prefill caches it: the window comes back promoted to fp32
    state = (gconv.bfloat16(), gssm)
    jstate = (jnp.asarray(wconv).astype(jnp.bfloat16), wssm)
    for step in range(2):
        x1 = _x((2, 1, tcfg.d_model), 20 + step)
        y, state = TS.mamba2_decode(tp, tcfg, _t(x1), state)
        wy, jstate = JS.mamba2_decode(_j(p), jcfg, jnp.asarray(x1), jstate)
        assert state[0].dtype == torch.float32 and jstate[0].dtype == jnp.float32
        _close(y, wy, msg=f"decode step {step}")
        _close(state[1], jstate[1])


def test_mamba2_state_handoff():
    """tests/test_models.py:123 on the port: the prefill's states decode the
    next token as the prefill of T + 1 computes it."""
    tcfg, _, p = _mamba(5)
    tp = _t(p)
    x = _t(_x((1, 32, tcfg.d_model), 6))
    _, state = TS.mamba2_forward(tp, tcfg, x)
    x2 = _t(_x((1, 1, tcfg.d_model), 7))
    y_cont, _ = TS.mamba2_decode(tp, tcfg, x2, state)
    y_full, _ = TS.mamba2_forward(tp, tcfg, torch.cat([x, x2], dim=1))
    np.testing.assert_allclose(y_cont[:, 0].numpy(), y_full[:, -1].numpy(), atol=1e-4)


# -------------------------------------------------------------------- RWKV6
@pytest.mark.parametrize("t", [32, 40])
def test_rwkv6_mixes_match_with_carries(t):
    """From a carried wkv state and token shift (a prefill's), the chunked
    and recurrent time mix and the channel mix against the reference's;
    chunked ≡ recurrent to the reference's 1e-4."""
    tcfg, jcfg = T.ARCHS["rwkv6-3b"].reduced(), J.ARCHS["rwkv6-3b"].reduced()
    p = _perturb(JRK.rwkv6_mix_init(jax.random.key(3), jcfg, jnp.float32))
    pc = _perturb(JRK.rwkv6_cmix_init(jax.random.key(4), jcfg, jnp.float32))
    x = _x((2, t, tcfg.d_model), 4)
    d, dh = tcfg.d_model, tcfg.ssm.d_head
    s0 = _x((2, d // dh, dh, dh), 5, 0.2)
    xl = _x((2, d), 6)
    tp, jp = _t(p), _j(p)
    outs = {}
    for name, tf, jf in (("chunked", TRK.rwkv6_mix_chunked, JRK.rwkv6_mix_chunked),
                         ("recurrent", TRK.rwkv6_mix_recurrent, JRK.rwkv6_mix_recurrent)):
        got, (gs, gx) = tf(tp, tcfg, _t(x), state=_t(s0), xlast=_t(xl))
        want, (ws, wx) = jax.jit(jf, static_argnums=1)(jp, jcfg, jnp.asarray(x),
                                                       jnp.asarray(s0), jnp.asarray(xl))
        _close(got, want, msg=name)
        _close(gs, ws, msg=name)
        assert gs.dtype == gx.dtype == torch.float32
        np.testing.assert_array_equal(gx.numpy(), np.asarray(wx))
        outs[name] = (got, gs)
    np.testing.assert_allclose(outs["chunked"][0].numpy(), outs["recurrent"][0].numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(outs["chunked"][1].numpy(), outs["recurrent"][1].numpy(),
                               atol=1e-4)
    got, gx = TRK.rwkv6_cmix(_t(pc), tcfg, _t(x), xlast=_t(xl))
    want, wx = jax.jit(JRK.rwkv6_cmix, static_argnums=1)(_j(pc), jcfg, jnp.asarray(x),
                                                         jnp.asarray(xl))
    _close(got, want)
    np.testing.assert_array_equal(gx.numpy(), np.asarray(wx))


@pytest.mark.parametrize("mixer", ["mamba2", "rwkv6"])
def test_sequence_shorter_than_the_chunk(mixer):
    """T = 10 < chunk = 16 is one chunk of 10, unpadded, in both packages:
    the chunked mixers and their states against the reference's."""
    if mixer == "mamba2":
        tcfg, jcfg, p = _mamba(8)
        tf, jf = TS.mamba2_forward, JS.mamba2_forward
    else:
        tcfg, jcfg = T.ARCHS["rwkv6-3b"].reduced(), J.ARCHS["rwkv6-3b"].reduced()
        p = _perturb(JRK.rwkv6_mix_init(jax.random.key(9), jcfg, jnp.float32))
        tf, jf = TRK.rwkv6_mix_chunked, JRK.rwkv6_mix_chunked
    assert tcfg.ssm.chunk == 16
    x = _x((2, 10, tcfg.d_model), 10)
    got, gstate = tf(_t(p), tcfg, _t(x))
    want, wstate = jax.jit(jf, static_argnums=1)(_j(p), jcfg, jnp.asarray(x))
    _close(got, want, msg=mixer)
    for g, w in zip(gstate, wstate):
        _close(g, w, msg=f"{mixer} state")
