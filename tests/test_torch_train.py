"""The port's training pieces against the JAX package's, on the CPU:

* the flash backward (``models/flash.py``, a ``torch.autograd.Function``)
  against the reference's ``custom_vjp`` through ``jax.vjp``, for the
  ``causal``, ``prefix`` and ``none`` masks, G > 1, dv ≠ dk, Tk not a
  whole number of blocks, and both ``perf_flags.FLASH_BF16`` values; in
  fp32 also against autograd through the dense ``sdpa_ref``;
* ``cross_entropy`` and ``chunked_ce`` (values and gradients, padded
  vocabulary, ignored labels), and ``lm_loss`` under ``CHUNKED_CE``;
* ``adamw_update`` over 3 steps on a tree with a stacked norm (decayed, as
  the reference decays its (L, D) leaf) and an unstacked one (not), with
  fp32 and with bf16 parameters and an fp32 master; ``clip_by_global_norm``;
  ``warmup_cosine``; int8 compression, bitwise;
* checkpoints: a tree saved by either package restored by the other,
  bitwise (bf16, fp32 and int32 leaves, nested dicts, lists, None); a
  model and its optimizer state; retention; async save; a mismatch
  failing;
* the supervisor's replay and straggler counts against the reference's
  under the same scripted failures and ``ManualClock`` steps;
* ``launch.train.main(--reduced --device cpu)`` with an injected failure:
  1 restart, and its loss history bitwise that of a run without one.

Tolerances: fp32 values and gradients to 1e-5 · max(1, max |y|) of the
reference's; under ``FLASH_BF16`` (bf16 operands of every product, fp32
sums) to 1e-3 · max(1, max |y|), as an fp32 sum that parts in the last
bits can round a product's operand to the neighbouring bf16 value; AdamW's
fp32 parameters, ``m``, ``v`` and master to 1e-6 · max(1, max |leaf|),
bf16 parameters to one bf16 ulp (rtol 2^-7).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as J  # noqa: E402
from repro import obs as JO  # noqa: E402
from repro.checkpoint import CheckpointManager as JCM  # noqa: E402
from repro.checkpoint import manager as JM  # noqa: E402
from repro.distributed import Supervisor as JSup  # noqa: E402
from repro.models import flash as JF  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import perf_flags as JPF  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.optim import adamw as JAd  # noqa: E402
from repro.optim import compress as JC  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch import obs as TO  # noqa: E402
from repro_torch import tree as TT  # noqa: E402
from repro_torch.checkpoint import CheckpointManager as TCM  # noqa: E402
from repro_torch.checkpoint import manager as TM  # noqa: E402
from repro_torch.distributed import Supervisor as TSup  # noqa: E402
from repro_torch.launch import train as TTrain  # noqa: E402
from repro_torch.models import flash as TF  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import perf_flags as TPF  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.optim import adamw as TAd  # noqa: E402
from repro_torch.optim import compress as TCo  # noqa: E402
from repro_torch.state import lm_params_from_numpy  # noqa: E402

pytestmark = pytest.mark.torch


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, what, scale=1e-5):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, f"{what}: {got.shape} against {want.shape}"
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=scale * max(1.0, float(np.abs(want).max())), err_msg=what)


# ------------------------------------------------------------------ flash
#: (kind, prefix, B, Tq, Tk, KV, G, dk, dv, block_k)
FLASH_CASES = [("causal", 0, 2, 20, 20, 2, 3, 16, 16, 8),
               ("prefix", 6, 1, 12, 12, 1, 2, 16, 8, 8),
               ("none", 0, 2, 5, 19, 3, 1, 8, 12, 8),
               ("causal", 0, 1, 33, 33, 2, 2, 24, 16, 16)]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: f"{c[0]}-tk{c[4]}-g{c[6]}")
def test_flash_backward(case, bf16, monkeypatch):
    kind, prefix, b, tq, tk, kv, g, dk, dv, block = case
    monkeypatch.setattr(JPF, "FLASH_BF16", bf16)
    monkeypatch.setattr(TPF, "FLASH_BF16", bf16)
    rng = np.random.default_rng(tq * 7 + tk)
    q = rng.normal(size=(b, tq, kv, g, dk)).astype(np.float32)
    k = rng.normal(size=(b, tk, kv, dk)).astype(np.float32)
    v = rng.normal(size=(b, tk, kv, dv)).astype(np.float32)
    do = rng.normal(size=(b, tq, kv, g, dv)).astype(np.float32)
    scale = dk ** -0.5
    out, vjp = jax.vjp(lambda q_, k_, v_: JF.flash_attention(q_, k_, v_, scale, kind, prefix,
                                                             block), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq_, tk_, tv_ = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    got_out = TF.flash_attention(tq_, tk_, tv_, scale, kind, prefix, block)
    got = torch.autograd.grad(got_out, (tq_, tk_, tv_), torch.from_numpy(do))
    tol = 1e-3 if bf16 else 1e-5
    _close(got_out, out, "out", tol)
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        _close(x, w, name, tol)
    if not bf16:  # the dense oracle's autograd
        dense = TF.sdpa_ref(tq_, tk_, tv_, scale, kind, prefix)
        ref = torch.autograd.grad(dense, (tq_, tk_, tv_), torch.from_numpy(do))
        for name, x, w in zip(("dq", "dk", "dv"), got, ref):
            _close(x, w, f"{name} against sdpa_ref", tol)


# --------------------------------------------------------------- the losses
def test_cross_entropy():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(3, 7, 40)).astype(np.float32) * 3
    labels = rng.integers(0, 33, (3, 7)).astype(np.int32)
    labels[1, 2:5] = -1
    mask = (rng.random((3, 7)) > 0.2).astype(np.int32)
    for kw in ({"vocab_valid": 33}, {"vocab_valid": 33, "mask": mask}, {}):
        jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
        tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
        val, grad = jax.value_and_grad(lambda x: JL.cross_entropy(x, jnp.asarray(labels),
                                                                  **jkw))(jnp.asarray(logits))
        x = torch.from_numpy(logits).requires_grad_(True)
        got = TL.cross_entropy(x, torch.from_numpy(labels), **tkw)
        _close(got, val, f"cross_entropy {sorted(kw)}")
        _close(torch.autograd.grad(got, x)[0], grad, f"cross_entropy grad {sorted(kw)}")


@pytest.mark.parametrize("chunk", [64, 100, 512])
def test_chunked_ce(chunk):
    rng = np.random.default_rng(chunk)
    n, d, v, valid_v = 24, 16, 256, 250
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = (rng.normal(size=(d, v)) * 0.3).astype(np.float32)
    labels = rng.integers(0, valid_v, (n,)).astype(np.int32)
    labels[:4] = -1
    valid = labels >= 0
    f = lambda x_, w_: JL.chunked_ce(x_, w_, jnp.asarray(labels), jnp.asarray(valid),  # noqa
                                     valid_v, chunk)
    val, (gx, gw) = jax.value_and_grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx, tw = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    got = TL.chunked_ce(tx, tw, torch.from_numpy(labels), torch.from_numpy(valid), valid_v,
                        chunk)
    _close(got, val, "chunked_ce")
    dx, dw = torch.autograd.grad(got, (tx, tw))
    _close(dx, gx, "chunked_ce dx")
    _close(dw, gw, "chunked_ce dw")
    dense = TL.cross_entropy(tx @ tw, torch.from_numpy(labels), vocab_valid=valid_v)
    _close(got, _np(dense), "chunked_ce against cross_entropy")


def test_lm_loss_chunked(monkeypatch):
    """qwen3 reduced (tied embeddings: the CE reads ``embed.T``) under
    CHUNKED_CE = 128: the loss and every gradient leaf."""
    monkeypatch.setattr(JPF, "CHUNKED_CE", 128)
    monkeypatch.setattr(TPF, "CHUNKED_CE", 128)
    jcfg, tcfg = J.ARCHS["qwen3-1.7b"].reduced(), TC.ARCHS["qwen3-1.7b"].reduced()
    jp = jax.jit(JR.build(jcfg, compute_dtype=jnp.float32, remat=False).init)(jax.random.key(0))
    rng = np.random.default_rng(2)
    batch = {"tokens": rng.integers(0, jcfg.vocab, (2, 12)).astype(np.int32),
             "labels": rng.integers(0, jcfg.vocab, (2, 12)).astype(np.int32)}
    batch["labels"][1, :4] = -1
    japi = JR.build(jcfg, compute_dtype=jnp.float32, remat=False)
    (jl, _), jg = jax.jit(jax.value_and_grad(japi.loss, has_aux=True))(
        jp, jax.tree.map(jnp.asarray, batch))
    params = lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    params.requires_grad_(True)
    api = TR.build(tcfg, compute_dtype=torch.float32, remat=False, device="cpu")
    loss, _ = api.loss(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, TT.leaves(params))
    _close(loss, jl, "lm_loss chunked")
    want = TT.leaves(lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, jg), device="cpu"))
    for i, (g, w) in enumerate(zip(grads, want)):
        _close(g, w, f"grad leaf {i}")


# -------------------------------------------------------------------- optim
L_, D_, F_ = 3, 8, 5


def _trees(rng, dtype):
    """The reference's tree (a segment stacked (L, ...)) and the port's (a
    stack of L layers), same values."""
    stacked = {"norm": {"scale": 1 + 0.1 * rng.normal(size=(L_, D_))},
               "w": rng.normal(size=(L_, D_, F_))}
    ref = {"embed": rng.normal(size=(11, D_)), "final_norm": {"scale": rng.normal(size=(D_,))},
           "segments": [stacked], "bias": rng.normal(size=(F_,))}
    ref = jax.tree.map(lambda a: np.asarray(a, np.float32), ref)
    layers = TT.Layers({"norm": {"scale": torch.tensor(stacked["norm"]["scale"][i])},
                        "w": torch.tensor(stacked["w"][i])} for i in range(L_))
    port = {"embed": torch.tensor(ref["embed"]), "final_norm": {
        "scale": torch.tensor(ref["final_norm"]["scale"])}, "segments": [layers],
        "bias": torch.tensor(ref["bias"])}
    port = TT.tree_map(lambda t: t.float().to(dtype), port)
    return jax.tree.map(lambda a: jnp.asarray(a, getattr(jnp, str(dtype)[6:])), ref), port


def _as_ref_leaves(tree):
    """The port's tree's leaves stacked as the reference's flatten order."""
    leaves = [_np(t) for t in TT.leaves(tree)]
    return [np.stack([leaves[i] for i in grp]) if len(grp) > 1 else leaves[grp[0]]
            for grp in TT.stacked_groups(tree)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw_three_steps(dtype):
    rng = np.random.default_rng(4)
    jp, tp = _trees(rng, dtype)
    master = dtype == torch.bfloat16
    jst, tst = JAd.adamw_init(jp, master_fp32=master), TAd.adamw_init(tp, master_fp32=master)
    for step in range(3):
        jg, tg = _trees(rng, torch.float32)
        lr = 0.05 * (step + 1)
        jp, jst = JAd.adamw_update(jp, jg, jst, lr, weight_decay=0.5)
        tp, tst = TAd.adamw_update(tp, tg, tst, torch.tensor(lr), weight_decay=0.5)
    assert int(tst["step"]) == int(jst["step"]) == 3
    names = ["m", "v"] + (["master"] if master else [])
    for name in names:
        for i, (g, w) in enumerate(zip(_as_ref_leaves(tst[name]), jax.tree.leaves(jst[name]))):
            _close(g, w, f"{name} leaf {i}", 1e-6)
    for i, (g, w) in enumerate(zip(_as_ref_leaves(tp), jax.tree.leaves(jp))):
        if master:
            np.testing.assert_allclose(g, _np(w), rtol=2 ** -7, atol=0, err_msg=f"param {i}")
        else:
            _close(g, w, f"param leaf {i}", 1e-6)
    # the stacked norm is decayed, the unstacked one is not: the decay term
    # is what moves a zero-gradient leaf
    rng = np.random.default_rng(5)
    jp, tp = _trees(rng, torch.float32)
    zeros = TT.tree_map(torch.zeros_like, tp)
    before = {k: _np(v).copy() for k, v in (("stacked", tp["segments"][0][0]["norm"]["scale"]),
                                     ("final", tp["final_norm"]["scale"]))}
    TAd.adamw_update(tp, zeros, TAd.adamw_init(tp), 0.1, weight_decay=0.5)
    assert np.all(_np(tp["segments"][0][0]["norm"]["scale"]) != before["stacked"])
    np.testing.assert_array_equal(_np(tp["final_norm"]["scale"]), before["final"])


def test_clip_and_schedule():
    rng = np.random.default_rng(6)
    jg, tg = _trees(rng, torch.float32)
    for max_norm in (0.5, 1e3):
        jc, jn = JAd.clip_by_global_norm(jg, max_norm)
        tc, tn = TAd.clip_by_global_norm(tg, max_norm)
        _close(tn, jn, "global norm", 1e-6)
        for i, (g, w) in enumerate(zip(_as_ref_leaves(tc), jax.tree.leaves(jc))):
            _close(g, w, f"clipped leaf {i}", 1e-6)
    steps = np.arange(0, 40, dtype=np.int32)
    _close(TAd.warmup_cosine(torch.from_numpy(steps), 3e-4, 5, 30),
           JAd.warmup_cosine(jnp.asarray(steps), 3e-4, 5, 30), "warmup_cosine", 1e-6)
    _close(TAd.warmup_cosine(torch.tensor(0, dtype=torch.int32), 1e-3, 0, 10),
           JAd.warmup_cosine(0, 1e-3, 0, 10), "warmup_cosine at warmup 0", 1e-6)


def test_int8_compress_bitwise():
    rng = np.random.default_rng(7)
    g = (rng.normal(size=(64, 33)) * 3).astype(np.float32)
    g[0, :4] = [0.5, -0.5, 1.5, 2.5]  # round half to even at scale 1 below
    for arr in (g, np.zeros((5,), np.float32), np.array([127.0, 0.5, 1.5, -2.5], np.float32)):
        jq, js = JC.compress_int8(jnp.asarray(arr))
        tq, ts = TCo.compress_int8(torch.from_numpy(arr))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert tq.dtype == torch.int8
        assert float(ts) == float(js)
        np.testing.assert_array_equal(TCo.decompress_int8(tq, ts).numpy(),
                                      np.asarray(JC.decompress_int8(jq, js)))


# --------------------------------------------------------------- checkpoints
def _ckpt_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(4, 6)).astype(np.float32),
            "b16": rng.normal(size=(3, 5)).astype(np.float32),
            "nested": {"i": rng.integers(-9, 9, (7,)).astype(np.int32), "none": None,
                       "list": [rng.normal(size=(2,)).astype(np.float32),
                                rng.normal(size=(1, 3)).astype(np.float32)]},
            "step": np.asarray(seed, np.int32)}


def _jax_tree(t):
    out = jax.tree.map(jnp.asarray, t)
    out["b16"] = out["b16"].astype(jnp.bfloat16)
    return out


def _torch_tree(t):
    out = TT.tree_map(lambda a: torch.from_numpy(np.array(a)), t)
    out["b16"] = out["b16"].to(torch.bfloat16)
    return out


def _same(torch_tree, jax_tree):
    tl, jl = TT.leaves(torch_tree), jax.tree.leaves(jax_tree)
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        assert tuple(t.shape) == j.shape
        if t.dtype == torch.bfloat16:
            assert str(j.dtype) == "bfloat16"
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          np.asarray(j).view(np.int16))
        else:
            assert str(t.dtype).removeprefix("torch.") == str(j.dtype)
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_checkpoint_across_packages(tmp_path):
    tree = _ckpt_tree(1)
    TM.save_tree(_torch_tree(tree), tmp_path / "port", step=3)
    JM.save_tree(_jax_tree(tree), tmp_path / "ref", step=3)
    m_port = json.loads((tmp_path / "port" / "manifest.json").read_text())
    m_ref = json.loads((tmp_path / "ref" / "manifest.json").read_text())
    assert m_port == m_ref
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        sorted(p.name for p in (tmp_path / "ref").iterdir())
    # saved by the port, restored by the reference; and the other way
    _same(_torch_tree(tree), JM.restore_tree(_jax_tree(_ckpt_tree(2)), tmp_path / "port"))
    _same(TM.restore_tree(_torch_tree(_ckpt_tree(2)), tmp_path / "ref"), _jax_tree(tree))


def test_checkpoint_model_and_state(tmp_path):
    from repro_torch.optim import adamw_init

    cfg = TC.ARCHS["zamba2-1.2b"].reduced()
    params = TR.build(cfg, compute_dtype=torch.float32, device="cpu").init()
    opt = adamw_init(params, master_fp32=True)
    opt["m"] = TT.tree_map(lambda t: t + 1.5, opt["m"])
    mgr = TCM(tmp_path)
    mgr.save(7, (params, opt), blocking=True)
    template = (TR.build(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(9)).init(), adamw_init(params))
    template[1]["master"] = TT.tree_map(torch.zeros_like, opt["master"])
    (p2, o2), step = mgr.restore(template)
    assert step == 7 and type(p2) is type(params) and p2 is not template[0]
    for a, b in zip(TT.leaves((params, opt)), TT.leaves((p2, o2))):
        assert torch.equal(a, b)
    assert not torch.equal(TT.leaves(template[0])[0], TT.leaves(params)[0])


def test_checkpoint_retention_async_mismatch(tmp_path):
    mgr = TCM(tmp_path, keep=2)
    for step in range(4):
        mgr.save(step, _torch_tree(_ckpt_tree(step)))  # async
    mgr.wait()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000002", "step_00000003"]
    assert mgr.latest_step() == 3
    restored, step = mgr.restore(_torch_tree(_ckpt_tree(0)))
    assert step == 3
    assert torch.equal(restored["w"], torch.from_numpy(_ckpt_tree(3)["w"]))
    bad = _torch_tree(_ckpt_tree(0))
    bad["w"] = torch.zeros((4, 7))
    with pytest.raises(ValueError, match="leaf"):
        mgr.restore(bad)
    with pytest.raises(ValueError, match="leaves"):
        mgr.restore({"w": torch.zeros((4, 6))})
    assert TCM(tmp_path / "empty").restore(bad) == (None, None)


# --------------------------------------------------------------- supervisor
def _supervise(pkg, tmp_path, fails, slow):
    """A counter state through 12 steps: ``fails`` the steps whose first try
    raises, ``slow`` the steps whose (virtual) time is 10 units, 1 else."""
    if pkg == "ref":
        clock, Sup, Mgr, arr = JO.ManualClock(), JSup, JCM, jnp.asarray
    else:
        clock, Sup, Mgr, arr = TO.ManualClock(), TSup, TCM, torch.tensor
    failed, hits = set(), []

    def step_fn(state, batch):
        i = int(state["i"])
        clock.advance(10.0 if i in slow else 1.0)
        if i in fails and i not in failed:
            failed.add(i)
            raise RuntimeError("injected")
        return {"i": state["i"] + 1, "acc": state["acc"] + batch}, {"acc": float(state["acc"])}

    sup = Sup(Mgr(tmp_path / pkg), ckpt_every=3, max_restarts=4, straggler_factor=3.0,
              on_straggler=lambda s, dt, ema: hits.append(s), clock=clock)
    res = sup.run({"i": arr(0), "acc": arr(0.0)}, step_fn, lambda s: arr(float(s + 1)), 12)
    return res.steps_done, res.restarts, res.stragglers, res.metrics_history, hits


@pytest.mark.parametrize("fails,slow", [((), (5,)), ((1, 7), (4, 9)), ((2, 2, 10), ())])
def test_supervisor_matches_reference(tmp_path, fails, slow):
    ref = _supervise("ref", tmp_path, set(fails), set(slow))
    got = _supervise("port", tmp_path, set(fails), set(slow))
    assert got == ref
    assert got[1] == len(set(fails))


# ----------------------------------------------------------------- launcher
def test_launch_train_restart(tmp_path, capsys):
    argv = ["--arch", "qwen3-1.7b", "--reduced", "--steps", "6", "--batch", "2", "--seq", "16",
            "--ckpt-every", "2", "--log-every", "1", "--device", "cpu"]
    runs = {}
    for name, extra in (("clean", []), ("failed", ["--inject-failure", "3"])):
        hist = tmp_path / f"{name}.json"
        assert TTrain.main(argv + extra + ["--ckpt", str(tmp_path / name),
                                           "--history", str(hist)]) == 0
        runs[name] = json.loads(hist.read_text())
    out = capsys.readouterr().out
    assert "(1 restarts, 0 stragglers)" in out and "(0 restarts, 0 stragglers)" in out
    clean, failed = runs["clean"]["losses"], runs["failed"]["losses"]
    assert runs["failed"]["restarts"] == 1 and runs["failed"]["steps_done"] == 6
    # steps 0-2 ran, the checkpoint after step 1 was restored, steps 2-5 replayed
    assert failed == clean[:3] + clean[2:]
