"""The train step on a named mesh in which each rank computes its own share
(``registry.make_train_step(..., mesh=)`` for the dense and vlm families,
``models/spmd.py``): FSDP over ``data``, tensor-parallel products over
``model``, a vocabulary-parallel embedding and loss, on meshes of logical
CPU shards, and the collectives of ``core.sharding`` it is built from.

The JAX side runs once, in one subprocess with four forced host devices:
the reference's ``make_train_step`` jitted with the planner's shardings on
``jax.make_mesh((2, 2), ("data", "model"))`` at ``grad_accum`` 1 and 2, from
the reference's init, on a batch whose two data ranks hold unequal numbers
of labelled tokens, for reduced qwen3-1.7b (query and kv heads split),
qwen2-1.5b reduced with ``n_heads=3`` (the heads do not divide: the whole
attention on each model rank) and reduced paligemma-3b (vlm: the patch
prefix, its prefix mask, one kv head read by the split query heads).

Tolerances, ``tests/test_torch_train_mesh.py``'s unchanged:
* against the reference's sharded step and against the port's
  single-device step from the same state: the metrics to 1e-5 · max(1,
  |value|); ``m`` and ``v`` leaves to δ = 1e-5 · max(1e-3, max |leaf|) +
  1e-6 · max(1, max |leaf| over the tree); a parameter to 1e-5 · max(1,
  max |p|) plus what δ moves Adam's first step (lr · min(2, 2 δ_g / (|g| +
  eps))).
* two runs of two steps: bitwise.
* the collectives: their values and gradients against the same sums in
  rank order, bitwise; the seams counted against
  ``roofline.collective_bytes``: equal.

77 s in the tier-1 command's whole run (6 workers, ``--dist loadfile``),
about 50 s alone: ``PYTHONPATH=src python -m pytest -q
tests/test_torch_train_tp.py`` (also under ``-m "torch and distributed"``).
"""
import copy
import dataclasses
import functools
import math
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch import tree as TT  # noqa: E402
from repro_torch.configs import ARCHS, TrainConfig  # noqa: E402
from repro_torch.core import sharding as CS  # noqa: E402
from repro_torch.launch.mesh import make_lm_mesh  # noqa: E402
from repro_torch.models import perf_flags, spmd  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models import sharding as SH  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.roofline import collective_bytes  # noqa: E402
from repro_torch.state import (gather_tree, lm_params_from_numpy,  # noqa: E402
                               opt_state_from_numpy, shard_tree)

pytestmark = [pytest.mark.torch, pytest.mark.distributed]

ROOT = Path(__file__).resolve().parent.parent
B, T = 8, 16
TRAIN = dict(lr=1e-2, warmup=2, total_steps=10, compute_dtype="float32")
#: (arch, reduced() overrides) held to the reference's sharded step
REF_ARCHS = (("qwen3-1.7b", {}), ("qwen2-1.5b", {"n_heads": 3}), ("paligemma-3b", {}))
REF_STEPS = tuple((a, k) for a, _ in REF_ARCHS for k in (1, 2))

_REFERENCE = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType
    from repro import configs as J
    from repro.models import registry as JR, sharding as JS
    from repro.optim import adamw_init

    inp = np.load(sys.argv[1])
    QUICK = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
    mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    archs = dict(eval(sys.argv[3]))
    steps = {}
    for arch, accum in eval(sys.argv[4]):
        cfg = J.ARCHS[arch].reduced(**archs[arch])
        params = jax.jit(JR.build(cfg, compute_dtype=jnp.float32).init,
                         compiler_options=QUICK)(jax.random.key(0))
        opt = adamw_init(params)
        batch = {k[len(arch) + 1:]: inp[k] for k in inp.files if k.startswith(arch + "/")}
        tc = J.TrainConfig(grad_accum=accum, **eval(sys.argv[5]))
        ps = JS.param_specs(cfg, params, mesh)
        os_ = JS.opt_specs(cfg, opt, mesh, ps)
        bs = JS.batch_specs(cfg, batch, mesh)
        step = JR.make_train_step(cfg, tc)
        metr = JS.replicated(mesh, jax.eval_shape(step, params, opt, batch)[2])
        fn = jax.jit(step, in_shardings=(ps, os_, bs), out_shardings=(ps, os_, metr),
                     compiler_options=QUICK)
        with mesh:
            p1, o1, met = fn(jax.device_put(params, ps), jax.device_put(opt, os_),
                             jax.device_put(batch, bs))
        steps[arch, accum] = jax.tree.map(np.asarray, dict(
            p0=params, p1=p1, m=o1["m"], v=o1["v"], step=o1["step"], met=met))
    with open(sys.argv[2], "wb") as f:
        pickle.dump(steps, f)
    print("OK")
""")


def _cfg(arch, **over):
    return ARCHS[arch].reduced(**over)


def _batch_np(cfg):
    """The batch as numpy arrays from a seed; labels are ignored in rank 0's
    rows only (unequal labelled tokens across the data ranks); a vlm's
    patches take ``vis_ctx`` positions before the ``T`` text tokens."""
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab, (B, T + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :5] = -1
    labels[2, 3:] = -1
    batch = {"tokens": toks[:, :-1].copy(), "labels": labels}
    if cfg.vis_ctx:
        batch["vis"] = rng.normal(size=(B, cfg.vis_ctx, cfg.vis_width)).astype(np.float32)
    return batch


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's steps, once for the file (one subprocess)."""
    d = tmp_path_factory.mktemp("train_tp")
    inp = {}
    for arch, over in REF_ARCHS:
        for k, v in _batch_np(_cfg(arch, **over)).items():
            inp[f"{arch}/{k}"] = v
    np.savez(d / "in.npz", **inp)
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _REFERENCE, str(d / "in.npz"),
                           str(d / "steps.pkl"), repr(REF_ARCHS), repr(REF_STEPS), repr(TRAIN)],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert "OK" in proc.stdout, proc.stderr[-3000:]
    with open(d / "steps.pkl", "rb") as f:
        return pickle.load(f)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mesh(shape=(2, 2), axes=("data", "model")):
    return make_lm_mesh(shape, axes, devices=("cpu",) * int(np.prod(shape)))


@functools.lru_cache(maxsize=8)
def _setup(arch, over=()):
    cfg = _cfg(arch, **dict(over))
    params = TR.build(cfg, compute_dtype=torch.float32, device="cpu",
                      generator=torch.Generator().manual_seed(3)).init()
    batch = {k: torch.from_numpy(v) for k, v in _batch_np(cfg).items()}
    return cfg, params, batch


def _place(cfg, params, batch, mesh):
    pspecs = SH.param_specs(cfg, params, mesh)
    opt = adamw_init(params)
    return (shard_tree(params, pspecs, mesh),
            shard_tree(opt, SH.opt_specs(cfg, opt, mesh, pspecs), mesh),
            shard_tree(batch, SH.batch_specs(cfg, batch, mesh), mesh))


def _split_run(cfg, params, batch, accum, mesh=None, steps=1):
    mesh = mesh or _mesh()
    sp, so, sb = _place(cfg, params, batch, mesh)
    step = TR.make_train_step(cfg, TrainConfig(grad_accum=accum, **TRAIN), mesh=mesh)
    for _ in range(steps):
        sp, so, met = step(sp, so, sb)
    return sp, so, met


def _single_run(cfg, params, batch, accum):
    params = copy.deepcopy(params)
    opt = adamw_init(params)
    step = TR.make_train_step(cfg, TrainConfig(grad_accum=accum, **TRAIN), device="cpu")
    return step(params, opt, batch)


def _leaf_tols(want, floor=1e-3):
    gmax = max(1.0, max(float(w.abs().max()) for w in want))
    return [1e-5 * max(floor, float(w.abs().max())) + 1e-6 * gmax for w in want]


def _check_against(sp, so, met, params, opt, want_met, what):
    """``tests/test_torch_train_mesh.py``'s check, its tolerances."""
    for k in want_met:
        got, want = float(met[k]), float(want_met[k])
        assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), f"{what} {k}: {got} against {want}"
    full_p, full_o = gather_tree(sp, "cpu"), gather_tree(so, "cpu")
    assert int(full_o["step"]) == int(opt["step"]) == 1
    for name in ("m", "v"):
        want = [x.detach() for x in TT.leaves(opt[name])]
        for i, (g, w, tol) in enumerate(zip(TT.leaves(full_o[name]), want, _leaf_tols(want))):
            assert float((g - w).abs().max()) <= tol, f"{what} {name} leaf {i}"
    m_ref = [x.detach() for x in TT.leaves(opt["m"])]
    lr0 = TRAIN["lr"] / TRAIN["warmup"]
    for i, (g, w, m, tol_m) in enumerate(zip(TT.leaves(full_p), TT.leaves(params), m_ref,
                                             _leaf_tols(m_ref))):
        grad, d_grad = m.abs() / 0.1, tol_m / 0.1  # b1 = 0.9: m = 0.1 g after one step
        tol = 1e-5 * max(1.0, float(w.detach().abs().max())) + lr0 * torch.clamp(
            2 * d_grad / (grad + 1e-8), max=2.0)
        assert bool(((g.detach() - w.detach()).abs() <= tol).all()), f"{what} param leaf {i}"


# --------------------------------------------------------- the collectives
def _ranks(mesh):
    return CS.RankSet(mesh)


def test_collectives_and_their_gradients():
    """On (data 2, model 2): each collective's value is its sum (or max, or
    concatenation) in rank order over the axis group, bitwise, and its
    gradient the transpose's: all-gather ↔ reduce-scatter, all-reduce's the
    identity, copy_to's an all-reduce."""
    mesh = _mesh()
    rs = _ranks(mesh)
    gen = torch.Generator().manual_seed(0)
    xs = [torch.randn((3, 4), generator=gen).requires_grad_(True) for _ in range(4)]
    groups = {"data": [[0, 2], [1, 3]], "model": [[0, 1], [2, 3]]}

    def in_order(ts):
        out = ts[0]
        for t in ts[1:]:
            out = out + t
        return out

    for axis, grps in groups.items():
        grp = {r: g for g in grps for r in g}
        ws = [torch.randn((6, 4), generator=gen) for _ in range(4)]
        got = CS.all_gather(rs, xs, axis, 0)
        grads = torch.autograd.grad(got, xs, grad_outputs=ws)
        for r in range(4):
            assert torch.equal(got[r], torch.cat([xs[g] for g in grp[r]]))
            k = grp[r].index(r)
            assert torch.equal(grads[r], in_order([ws[g][3 * k:3 * k + 3] for g in grp[r]]))
        got = CS.all_reduce(rs, xs, axis)
        vs = [torch.randn((3, 4), generator=gen) for _ in range(4)]
        grads = torch.autograd.grad(got, xs, grad_outputs=vs)
        for r in range(4):
            assert torch.equal(got[r], in_order([xs[g] for g in grp[r]]))
            assert torch.equal(grads[r], vs[r])
        got = CS.copy_to(rs, xs, axis)
        grads = torch.autograd.grad(got, xs, grad_outputs=vs)
        for r in range(4):
            assert torch.equal(got[r], xs[r])
            assert torch.equal(grads[r], in_order([vs[g] for g in grp[r]]))
        got = CS.reduce_scatter(rs, [w.requires_grad_(True) for w in ws], axis, 0)
        back = torch.autograd.grad(got, ws, grad_outputs=xs)
        for r in range(4):
            k = grp[r].index(r)
            assert torch.equal(got[r], in_order([ws[g][3 * k:3 * k + 3] for g in grp[r]]))
            assert torch.equal(back[r], torch.cat([xs[g] for g in grp[r]]))
        got = CS.all_reduce_max(rs, xs, axis)
        for r in range(4):
            assert torch.equal(got[r], torch.maximum(*[xs[g] for g in grp[r]]))


# ------------------------------------------------------- against the JAX step
@pytest.mark.parametrize("arch,accum", REF_STEPS)
def test_split_step_matches_the_reference(ref, arch, accum):
    """The reference's step jitted on its (data 2, model 2) mesh and the
    port's split step on its own, from the reference's init and the same
    batch."""
    over = dict(REF_ARCHS)[arch]
    cfg = _cfg(arch, **over)
    assert spmd.splits(cfg)
    want = ref[arch, accum]
    params = lm_params_from_numpy(cfg, want["p0"], device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch_np(cfg).items()}
    sp, so, met = _split_run(cfg, params, batch, accum)
    assert sorted(met) == sorted(want["met"])
    _check_against(sp, so, met, lm_params_from_numpy(cfg, want["p1"], device="cpu"),
                   opt_state_from_numpy(cfg, want, device="cpu"), want["met"],
                   f"{arch} accum {accum} against the reference")


# ------------------------------------------------- within the port
@pytest.mark.parametrize("arch,accum", [(a, k) for a in ("stablelm-3b", "starcoder2-15b")
                                        for k in (1, 2)])
def test_split_step_matches_single_device(arch, accum):
    """stablelm-3b (LayerNorm, heads and kv split) and starcoder2-15b
    (biases, a plain gelu MLP, one kv head read by the split query heads)
    reduced: the split step against the single-device step from the same
    state."""
    cfg, params, batch = _setup(arch)
    sp, so, met = _split_run(cfg, params, batch, accum)
    p1, o1, want = _single_run(cfg, params, batch, accum)
    _check_against(sp, so, met, p1, o1, want, f"{arch} accum {accum}")


def test_split_step_with_pods_and_chunked_ce():
    """qwen3-1.7b reduced on (pod 2, data 2, model 2), eight ranks, with
    ``grad_accum`` 2, and with ``perf_flags.CHUNKED_CE`` on (the vocabulary
    block streamed in chunks, the same all-reduces): the single-device
    step's, with the flag as it is there."""
    cfg, params, batch = _setup("qwen3-1.7b")
    mesh = _mesh((2, 2, 2), ("pod", "data", "model"))
    sp, so, met = _split_run(cfg, params, batch, 2, mesh=mesh)
    p1, o1, want = _single_run(cfg, params, batch, 2)
    _check_against(sp, so, met, p1, o1, want, "qwen3 on (pod, data, model)")
    old = perf_flags.CHUNKED_CE
    try:
        perf_flags.CHUNKED_CE = 96
        sp, so, met = _split_run(cfg, params, batch, 2)
        p1, o1, want = _single_run(cfg, params, batch, 2)
    finally:
        perf_flags.CHUNKED_CE = old
    _check_against(sp, so, met, p1, o1, want, "qwen3 with CHUNKED_CE")


def _states(sp, so, met):
    out = [x.detach() for r in range(sp.mesh.size) for x in sp.leaves(r) + so.leaves(r)]
    return out + [met[k] for k in sorted(met)]


@pytest.mark.parametrize("arch", ["stablelm-3b", "starcoder2-15b"])
def test_split_step_is_bitwise_repeatable(arch):
    """Two runs of two steps at ``grad_accum`` 2: every block of every rank
    and the metrics, bitwise."""
    cfg, params, batch = _setup(arch)
    runs = [_states(*_split_run(cfg, params, batch, 2, steps=2)) for _ in range(2)]
    assert len(runs[1]) == len(runs[0])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


# ------------------------------------------------------------- the structure
class _Record(TorchDispatchMode):
    """Every op's output shapes, with the rank whose work it is."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func._overloadpacket.__name__
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.seen.append((CS.current_rank(), name, tuple(t.shape), t.dtype))
        return out


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "paligemma-3b"])
def test_each_rank_computes_its_share(arch):
    """Under ``on_rank(r)`` each rank's products are on its own blocks and
    rows: its query projections, MLP hidden states and logits at 1/model of
    the split leaf's width (shapes made distinct: 4 heads of 24 (and 4 kv
    heads for qwen3), d_ff 320, d_model 128, a vocabulary of 700 padded to
    768); no op of the step
    makes a tensor with a whole-vocabulary dimension, a whole parameter of
    a leaf split over ``model`` or its whole gradient, or a tensor of the
    global batch."""
    cfg = _cfg(arch, d_ff=320, d_head=24, vocab=700, **({"n_kv": 4} if arch == "qwen3-1.7b"
                                                          else {}))
    params = TR.build(cfg, compute_dtype=torch.float32, device="cpu",
                      generator=torch.Generator().manual_seed(3)).init()
    batch = {k: torch.from_numpy(v) for k, v in _batch_np(cfg).items()}
    mesh = _mesh()
    sp, so, sb = _place(cfg, params, batch, mesh)
    step = TR.make_train_step(cfg, TrainConfig(**TRAIN), mesh=mesh)
    with _Record() as rec:
        step(sp, so, sb)
    q, ffn, vocab = cfg.n_heads * cfg.head_dim, cfg.d_ff, cfg.padded_vocab
    assert len({q, ffn, vocab, cfg.d_model, vocab // 2}) == 5
    whole_split = {tuple(x.shape) for x, spec in zip(TT.leaves(params), sp.spec_leaves())
                   if "model" in spec}
    rows, t_all = B // 2, T + (cfg.vis_ctx or 0)
    shapes = {s for _, _, s, _ in rec.seen}
    assert not any(len(s) > 1 and vocab in s for s in shapes), "a whole-vocabulary tensor"
    assert not shapes & whole_split, shapes & whole_split
    whole_batch = {(s, dt) for s, dt in ((tuple(x.shape), x.dtype) for x in batch.values())}
    assert not {(s, dt) for _, _, s, dt in rec.seen} & whole_batch, "the global batch"
    for r in range(mesh.size):
        # each product's output as (rows, width): einsum dispatches a bmm
        mine = {(math.prod(s[:-1]), s[-1]) for rank, n, s, _ in rec.seen
                if rank == r and n in ("mm", "bmm")}
        assert (rows * t_all, q // 2) in mine and (rows * t_all, q) not in mine, r
        assert (rows * t_all, ffn // 2) in mine and (rows * t_all, ffn) not in mine, r
        assert (rows * T, vocab // 2) in mine, r


# ---------------------------------------------------------------- the seams
@pytest.mark.parametrize("arch,accum,shape", [
    ("qwen2-1.5b", 2, (2, 2)), ("paligemma-3b", 2, (2, 2)), ("starcoder2-15b", 1, (2, 2)),
    ("qwen3-1.7b", 2, (2, 2, 2))])
def test_seams_equal_collective_bytes(arch, accum, shape):
    """The crossings rank 0 sends and receives in a real step (every rank
    run) equal ``roofline.collective_bytes`` from the specs, and a count of
    rank 0's program alone on ``meta`` devices (the dry run's)."""
    from repro_torch.launch import dryrun as D
    from repro_torch.configs import ShapeCell
    from repro_torch.core.sharding import NamedMesh

    axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    cfg, params, batch = _setup(arch)
    mesh = _mesh(shape, axes)
    sp, so, sb = _place(cfg, params, batch, mesh)
    tcfg = TrainConfig(grad_accum=accum, **TRAIN)
    step = TR.make_train_step(cfg, tcfg, mesh=mesh)
    with CS.count_seams() as real:
        step(sp, so, sb)
    want = collective_bytes(mesh, params, sp.specs, batch, sb.specs, cfg=cfg, tcfg=tcfg)
    assert real == want
    assert real["all-reduce"]["count"] > 0 and real["all-gather"]["count"] > 0
    if accum > 1:
        assert real["all-to-all"]["count"] > 0
    cell = ShapeCell("t", T + (cfg.vis_ctx or 0), B, "train")
    built = D.build_cell(cfg, cell, NamedMesh(shape, axes), tcfg=tcfg)
    assert built["spmd"] and built["coll"] == want
    assert D.count(built["fn"], *built["args"])["collectives"] == want


def test_whole_leaf_gradients_agree_across_ranks():
    """qwen3 reduced on (data 2, model 2) with one step: every copy of a
    block the planner replicates (norms, ``q_norm``/``k_norm``, which a
    split attention reads in part) is the same after the update."""
    cfg, params, batch = _setup("qwen3-1.7b")
    mesh = _mesh()
    sp, so, _ = _split_run(cfg, params, batch, 1, mesh=mesh)
    copies = 0
    for i, spec in enumerate(sp.spec_leaves()):
        first = {}
        for r in range(mesh.size):
            q = first.setdefault(CS.block_index(spec, mesh, r), r)
            if q != r:
                copies += 1
                assert torch.equal(sp.leaves(r)[i], sp.leaves(q)[i]), (i, spec)
                assert torch.equal(so.leaves(r)[i], so.leaves(q)[i]), (i, spec)
    assert copies > 0
    partial = spmd.model_partial(spmd.Layout(cfg, mesh, sp.specs), sp.specs)
    names = [path[-2] for (path, _), p in zip(TT.flatten_with_path(sp.specs), partial) if p]
    assert set(names) == {"q_norm", "k_norm"}, names


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "whisper-large-v3"])
def test_gathered_step_replicas_agree(arch):
    """The other families' gathered step, which shares the clip and AdamW
    with the split step: after a clipped step every copy of a replicated
    block (its gradient blocks views of one gradient on logical shards) is
    the same, parameters and AdamW state."""
    cfg = _cfg(arch)
    params = TR.build(cfg, compute_dtype=torch.float32, device="cpu",
                      generator=torch.Generator().manual_seed(3)).init()
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab, (B, T + 1)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
             "labels": torch.from_numpy(toks[:, 1:].copy())}
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy(
            (rng.normal(size=(B, cfg.enc_ctx, cfg.d_model)) * 0.1).astype(np.float32))
    mesh = _mesh()
    sp, so, met = _split_run(cfg, params, batch, 1, mesh=mesh)
    assert not spmd.splits(cfg) and float(met["gnorm"]) > 1.0  # the clip scales
    copies = 0
    for i, spec in enumerate(sp.spec_leaves()):
        first = {}
        for r in range(mesh.size):
            q = first.setdefault(CS.block_index(spec, mesh, r), r)
            if q != r:
                copies += 1
                assert torch.equal(sp.leaves(r)[i], sp.leaves(q)[i]), (i, spec)
                assert torch.equal(so.leaves(r)[i], so.leaves(q)[i]), (i, spec)
    assert copies > 0


def test_other_families_keep_the_gathered_step():
    """MoE, Whisper and the SSM families are not split (ROADMAP 14b-iv);
    the dense and vlm families are."""
    assert all(spmd.splits(ARCHS[a]) for a in ("qwen3-1.7b", "qwen2-1.5b", "stablelm-3b",
                                               "starcoder2-15b", "paligemma-3b"))
    assert not any(spmd.splits(ARCHS[a]) for a in ("qwen2-moe-a2.7b", "deepseek-v2-236b",
                                                   "whisper-large-v3", "rwkv6-3b",
                                                   "zamba2-1.2b"))
    cfg = dataclasses.replace(ARCHS["qwen3-1.7b"].reduced(), n_heads=4, n_kv=2)
    assert spmd.splits(cfg)
