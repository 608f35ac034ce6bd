"""LM training on a named mesh of logical CPU shards: the sharded train step
(``registry.make_train_step(..., mesh=)``), the activation anchors
(``models.meshops``), ``optim.ef_compressed_mean``,
``distributed.pipeline_apply`` and ``distributed.remesh``.

The JAX side runs once, in one subprocess with eight forced host devices:
the reference's ``make_train_step`` jitted with the planner's shardings on
``jax.make_mesh((2, 2), ("data", "model"))`` (reduced qwen3-1.7b,
qwen2-moe-a2.7b and whisper-large-v3 from the reference's init, a batch
whose two data ranks hold unequal numbers of labelled tokens),
``ef_compressed_mean`` under ``shard_map`` on ("pod",) = 4,
``pipeline_apply``'s forward on ``tests/test_checkpoint_ft.py``'s fixture
(its ``jax.grad`` raises on the installed JAX, so the port's gradient is
held to autograd through the port's sequential stack instead), and
``remesh`` from 8 ranks to 4 (the fixture's (8,) → (4,) and a (4, 2) →
(2, 2) tree).

Tolerances:
* the sharded step on a (data 2, model 2) mesh, fp32, ``grad_accum`` 1 and
  2, against the reference's sharded step and against the port's
  single-device step from the same state: the metrics to 1e-5 · max(1,
  |value|); ``m`` and ``v`` leaves to δ = 1e-5 · max(1e-3, max |leaf|) +
  1e-6 · max(1, max |leaf| over the tree); a parameter to 1e-5 · max(1,
  max |p|) plus what δ moves Adam's first step (lr · min(2, 2 δ_g / (|g| +
  eps)), ``tests/test_torch_train_models.py``'s bound).
* the sharded step, two runs of two steps: bitwise.
* ``ef_compressed_mean``: bitwise the reference; the residual exactly
  g32 − dequant(q); |mean − true mean| ≤ scale.
* ``pipeline_apply``: the forward to 1e-5 of the reference's; the gradient
  to 1e-5 · max(1, max |grad|) of autograd through the sequential stack.
* ``remesh``: bitwise the reference's shards.
"""
import copy
import functools
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import tree as TT  # noqa: E402
from repro_torch.configs import ARCHS, TrainConfig  # noqa: E402
from repro_torch.core.sharding import Spec, block_index  # noqa: E402
from repro_torch.distributed import pipeline_apply, remesh  # noqa: E402
from repro_torch.distributed.pipeline import split_stages  # noqa: E402
from repro_torch.launch.mesh import make_lm_mesh  # noqa: E402
from repro_torch.models import meshops  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models import sharding as SH  # noqa: E402
from repro_torch.optim import adamw_init, ef_compressed_mean  # noqa: E402
from repro_torch.state import (ShardedTree, gather_tree, lm_params_from_numpy,  # noqa: E402
                               opt_state_from_numpy, shard_tree, sharded_map)

pytestmark = [pytest.mark.torch, pytest.mark.distributed]

ROOT = Path(__file__).resolve().parent.parent
B, T = 8, 16
TRAIN = dict(lr=1e-2, warmup=2, total_steps=10, compute_dtype="float32")
EF_SHAPE = (4, 96, 40)
#: (arch, grad_accum) of the steps held to the reference's sharded step
REF_STEPS = (("qwen3-1.7b", 1), ("qwen3-1.7b", 2), ("qwen2-moe-a2.7b", 1),
             ("qwen2-moe-a2.7b", 2), ("whisper-large-v3", 2))

_REFERENCE = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.experimental.shard_map import shard_map
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
    from repro import configs as J
    from repro.distributed import pipeline_apply, remesh
    from repro.distributed.pipeline import split_stages
    from repro.models import registry as JR, sharding as JS
    from repro.optim import adamw_init, ef_compressed_mean

    inp = np.load(sys.argv[1])
    out = {}
    # the sharded train step on (data 2, model 2), fp32, from the reference's init
    QUICK = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
    mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    steps = {}
    for arch, accum in eval(sys.argv[3]):
        cfg = J.ARCHS[arch].reduced()
        params = jax.jit(JR.build(cfg, compute_dtype=jnp.float32).init,
                         compiler_options=QUICK)(jax.random.key(0))
        opt = adamw_init(params)
        batch = {k[len(arch) + 1:]: inp[k] for k in inp.files if k.startswith(arch + "/")}
        tc = J.TrainConfig(grad_accum=accum, **eval(sys.argv[4]))
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
    with open(sys.argv[2] + ".steps", "wb") as f:
        pickle.dump(steps, f)
    # ef_compressed_mean over ("pod",) = 4
    mesh = jax.make_mesh((4,), ("pod",))
    fn = shard_map(lambda g, r: tuple(x[None] for x in ef_compressed_mean(g[0], r[0], "pod")),
                   mesh=mesh, in_specs=(P("pod"), P("pod")), out_specs=(P("pod"), P("pod")),
                   check_rep=False)
    mean, res = fn(jnp.asarray(inp["ef_g"]), jnp.asarray(inp["ef_r"]))
    out["ef_mean"], out["ef_res"] = np.asarray(mean), np.asarray(res)
    # pipeline_apply: tests/test_checkpoint_ft.py's fixture, forward only
    mesh = jax.make_mesh((4,), ("pipe",))
    L, D, M, MB = 8, 16, 6, 4
    ks = jax.random.split(jax.random.key(0), L)
    layers = {"w": jax.vmap(lambda k: jax.random.normal(k, (D, D)) * 0.2)(ks)}

    def stage_fn(params, x):
        def body(h, w):
            return jnp.tanh(h @ w) + h, None
        h, _ = jax.lax.scan(body, x, params["w"])
        return h

    xs = jax.random.normal(jax.random.key(1), (M, MB, D))
    out["pipe_w"], out["pipe_xs"] = np.asarray(layers["w"]), np.asarray(xs)
    out["pipe_out"] = np.asarray(pipeline_apply(stage_fn, split_stages(layers, 4), xs, mesh))
    # remesh 8 -> 4: the fixture's (8,) -> (4,), and a (4, 2) -> (2, 2) tree
    devs = np.array(jax.devices())
    m8 = jax.make_mesh((8,), ("data",))
    m4 = jax.sharding.Mesh(devs[:4], ("data",))
    x = jnp.arange(64, dtype=jnp.float32).reshape(8, 8)
    moved = remesh(jax.device_put(x, NamedSharding(m8, P("data"))),
                   lambda mesh: NamedSharding(mesh, P("data")), m4)
    out["rm1"] = np.stack([np.asarray(s.data) for s in
                           sorted(moved.addressable_shards, key=lambda s: s.device.id)])
    src = jax.sharding.Mesh(devs.reshape(4, 2), ("data", "model"))
    dst = jax.sharding.Mesh(devs[:4].reshape(2, 2), ("data", "model"))
    specs = {"w": P("data", "model"), "v": P(None, "model"), "b": P()}
    tree = {k: jnp.asarray(inp[f"rm_{k}"]) for k in specs}
    placed = {k: jax.device_put(v, NamedSharding(src, specs[k])) for k, v in tree.items()}
    moved = remesh(placed, lambda mesh: {k: NamedSharding(mesh, s) for k, s in specs.items()},
                   dst)
    for k, v in moved.items():
        ids = [d.id for d in dst.devices.flat]
        by = {s.device.id: np.asarray(s.data) for s in v.addressable_shards}
        out[f"rm2_{k}"] = np.stack([by[i] for i in ids])
    np.savez(sys.argv[2], **out)
    print("OK")
""")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's outputs, once for the file (one subprocess)."""
    d = tmp_path_factory.mktemp("train_mesh")
    rng = np.random.default_rng(5)
    scales = np.array([1.0, 10.0, 0.1, 3.0], np.float32)[:, None, None]
    inp = {"ef_g": (rng.normal(size=EF_SHAPE) * scales).astype(np.float32),
           "ef_r": (rng.normal(size=EF_SHAPE) * 0.01).astype(np.float32),
           "rm_w": rng.normal(size=(8, 6)).astype(np.float32),
           "rm_v": rng.normal(size=(3, 4)).astype(np.float32),
           "rm_b": rng.normal(size=(5,)).astype(np.float32)}
    for arch in sorted({a for a, _ in REF_STEPS}):
        for k, v in _batch_np(ARCHS[arch].reduced(), masked=True).items():
            inp[f"{arch}/{k}"] = v
    np.savez(d / "in.npz", **inp)
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _REFERENCE, str(d / "in.npz"),
                           str(d / "out.npz"), repr(REF_STEPS), repr(TRAIN)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert "OK" in proc.stdout, proc.stderr[-3000:]
    with open(d / "out.npz.steps", "rb") as f:
        steps = pickle.load(f)
    return {**inp, **dict(np.load(d / "out.npz")), "steps": steps}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mesh(shape=(2, 2), axes=("data", "model")):
    return make_lm_mesh(shape, axes, devices=("cpu",) * int(np.prod(shape)))


def _batch_np(cfg, masked):
    """The batch as numpy arrays from a seed; ``masked`` ignores labels in
    rank 0's rows only (unequal labelled tokens across the data ranks)."""
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab, (B, T + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    if masked:
        labels[0, :5] = -1
        labels[2, 3:] = -1
    batch = {"tokens": toks[:, :-1].copy(), "labels": labels}
    if cfg.family == "audio":
        batch["frames"] = (rng.normal(size=(B, cfg.enc_ctx, cfg.d_model)) * 0.1).astype(
            np.float32)
    return batch


@functools.lru_cache(maxsize=8)
def _setup(arch, masked):
    """(config, parameters, batch) from seeds (``_batch_np``)."""
    cfg = ARCHS[arch].reduced()
    params = TR.build(cfg, compute_dtype=torch.float32, device="cpu",
                      generator=torch.Generator().manual_seed(3)).init()
    batch = {k: torch.from_numpy(v) for k, v in _batch_np(cfg, masked).items()}
    return cfg, params, batch


def _place(cfg, params, batch, mesh, master=False):
    pspecs = SH.param_specs(cfg, params, mesh)
    opt = adamw_init(params, master)
    return (shard_tree(params, pspecs, mesh),
            shard_tree(opt, SH.opt_specs(cfg, opt, mesh, pspecs), mesh),
            shard_tree(batch, SH.batch_specs(cfg, batch, mesh), mesh))


def _sharded_run(arch, accum, masked=False, steps=1, params=None):
    cfg, init, batch = _setup(arch, masked)
    mesh = _mesh()
    sp, so, sb = _place(cfg, init if params is None else params, batch, mesh)
    step = TR.make_train_step(cfg, TrainConfig(grad_accum=accum, **TRAIN), mesh=mesh)
    for _ in range(steps):
        sp, so, met = step(sp, so, sb)
    return sp, so, met


def _single_run(arch, accum, masked=False):
    cfg, params, batch = _setup(arch, masked)
    params = copy.deepcopy(params)
    opt = adamw_init(params)
    step = TR.make_train_step(cfg, TrainConfig(grad_accum=accum, **TRAIN), device="cpu")
    params, opt, met = step(params, opt, batch)
    return params, opt, met


def _leaf_tols(want, floor=1e-3):
    gmax = max(1.0, max(float(w.abs().max()) for w in want))
    return [1e-5 * max(floor, float(w.abs().max())) + 1e-6 * gmax for w in want]


def _check_against(sp, so, met, params, opt, want_met, what):
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


@pytest.mark.parametrize("arch,accum", [(a, k) for a in ("qwen3-1.7b", "whisper-large-v3",
                                                      "qwen2-moe-a2.7b") for k in (1, 2)])
def test_sharded_step_matches_single_device(arch, accum):
    """From the same state and a batch whose data ranks hold unequal numbers
    of labelled tokens: the single-device step's token mean, MoE capacity
    and aux loss."""
    sp, so, met = _sharded_run(arch, accum, masked=True)
    params, opt, want = _single_run(arch, accum, masked=True)
    _check_against(sp, so, met, params, opt, want, f"{arch} accum {accum}")


@pytest.mark.parametrize("arch,accum", REF_STEPS)
def test_sharded_step_matches_the_reference(ref, arch, accum):
    """The reference's step jitted on its (data 2, model 2) mesh and the
    port's on its own, from the reference's init and the same batch."""
    cfg = ARCHS[arch].reduced()
    want = ref["steps"][arch, accum]
    params = lm_params_from_numpy(cfg, want["p0"], device="cpu")
    sp, so, met = _sharded_run(arch, accum, masked=True, params=params)
    assert sorted(met) == sorted(want["met"])
    _check_against(sp, so, met, lm_params_from_numpy(cfg, want["p1"], device="cpu"),
                   opt_state_from_numpy(cfg, want, device="cpu"), want["met"],
                   f"{arch} accum {accum} against the reference")


def _states(sp, so, met):
    out = [x.detach() for r in range(sp.mesh.size) for x in sp.leaves(r) + so.leaves(r)]
    return out + [met[k] for k in sorted(met)]


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen2-moe-a2.7b"])
def test_sharded_step_is_bitwise_repeatable(arch):
    """Two runs of two steps: every block of every rank, the metrics,
    bitwise."""
    runs = [_states(*_sharded_run(arch, 2, masked=True, steps=2)) for _ in range(2)]
    assert len(runs[1]) == len(runs[0])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_sharded_state_round_trips_and_replicas_agree():
    """shard_tree then gather_tree is the identity, bitwise; AdamW's state
    made rank by rank (sharded_map) is the whole state placed; after a step,
    every copy of a replicated block (the norms, on both model ranks) is
    the same."""
    cfg, params, batch = _setup("qwen3-1.7b", False)
    mesh = _mesh()
    sp, so, sb = _place(cfg, params, batch, mesh, master=True)
    back = gather_tree(sp, "cpu")
    assert type(back) is type(params)
    assert all(torch.equal(a, b) for a, b in zip(TT.leaves(back), TT.leaves(params)))
    local = sharded_map(lambda t: adamw_init(t, True), sp, so.specs)
    assert local.shapes == so.shapes
    for r in range(mesh.size):
        assert all(torch.equal(a, b) for a, b in zip(local.leaves(r), so.leaves(r)))
    sp, so, _ = TR.make_train_step(cfg, TrainConfig(**TRAIN), mesh=mesh)(sp, so, sb)
    copies = 0
    for i, spec in enumerate(sp.spec_leaves()):
        first = {}
        for r in range(mesh.size):
            q = first.setdefault(block_index(spec, mesh, r), r)
            if q != r:
                copies += 1
                assert torch.equal(sp.leaves(r)[i], sp.leaves(q)[i]), (i, spec)
    assert copies > 0
    assert "master" in so.ranks[0]


def test_anchors_check_the_local_batch():
    cfg, params, batch = _setup("qwen3-1.7b", False)
    mesh = _mesh()
    x = torch.zeros((3, 4, 8))
    assert meshops.shard_residual(x) is x  # no mesh: nothing
    assert meshops.current_mesh() is None
    y = torch.zeros((4, 4, 8))
    with meshops.use_mesh(mesh, 4):
        assert meshops.current_mesh() is mesh
        assert meshops.shard_residual(y) is y
        assert meshops.shard_logits(y) is y
    with meshops.use_mesh(mesh, 4), pytest.raises(ValueError, match="anchor"):
        meshops.shard_residual(x)  # not the microbatch's rows
    with meshops.use_mesh(mesh, 3), pytest.raises(ValueError, match="anchor"):
        meshops.shard_residual(x)  # 3 rows do not split over data 2
    with meshops.use_mesh(mesh, 4), pytest.raises(ValueError, match="anchor"):
        TR.build(cfg, compute_dtype=torch.float32, device="cpu").loss(params, batch)
    assert meshops.current_mesh() is None
    # a batch whose rows are not split over (pod, data) is refused
    sp, so, _ = _place(cfg, params, batch, mesh)
    whole = shard_tree(batch, SH.replicated(mesh, batch), mesh)
    step = TR.make_train_step(cfg, TrainConfig(**TRAIN), mesh=mesh)
    with pytest.raises(ValueError, match="rows must be split"):
        step(sp, so, whole)


def test_ef_compressed_mean_matches_the_reference(ref):
    mesh = _mesh((4,), ("pod",))
    g = [torch.from_numpy(x) for x in ref["ef_g"]]
    r = [torch.from_numpy(x) for x in ref["ef_r"]]
    means, res = ef_compressed_mean(g, r, "pod", mesh)
    for i in range(4):
        assert np.array_equal(means[i].numpy(), ref["ef_mean"][i])
        assert np.array_equal(res[i].numpy(), ref["ef_res"][i])
    g32 = [a + b for a, b in zip(g, r)]
    scale = max(float(x.abs().max()) for x in g32) / 127.0
    q = [torch.round(x / torch.tensor(scale, dtype=torch.float32)) for x in g32]
    true = sum(g32) / 4
    assert float((means[0] - true).abs().max()) <= scale
    for x, qi, ri in zip(g32, q, res):
        assert torch.equal(ri, x - qi.clamp(-127, 127) * torch.tensor(scale, dtype=torch.float32))


def _stage_fn(params, x):
    for w in params["w"]:
        x = torch.tanh(x @ w) + x
    return x


def test_pipeline_forward_matches_the_reference(ref):
    mesh = _mesh((4,), ("pipe",))
    w = torch.from_numpy(ref["pipe_w"])
    out = pipeline_apply(_stage_fn, split_stages({"w": w}, 4), torch.from_numpy(ref["pipe_xs"]),
                         mesh)
    assert out.shape == ref["pipe_out"].shape
    assert float((out - torch.from_numpy(ref["pipe_out"])).abs().max()) <= 1e-5


def test_pipeline_gradient_matches_sequential_autograd(ref):
    mesh = _mesh((4,), ("pipe",))
    xs = torch.from_numpy(ref["pipe_xs"])
    w = torch.from_numpy(ref["pipe_w"]).requires_grad_(True)
    out = pipeline_apply(_stage_fn, split_stages({"w": w}, 4), xs, mesh)
    got, = torch.autograd.grad((out ** 2).sum(), [w])
    seq = torch.stack([_stage_fn({"w": w}, x) for x in xs])
    want, = torch.autograd.grad((seq ** 2).sum(), [w])
    assert float((got - want).abs().max()) <= 1e-5 * max(1.0, float(want.abs().max()))
    with pytest.raises(ValueError, match="stages"):
        split_stages({"w": w}, 3)


def test_remesh_matches_the_reference(ref):
    m8, m4 = _mesh((8,), ("data",)), _mesh((4,), ("data",))
    x = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    moved = remesh(shard_tree(x, Spec(("data", None)), m8), lambda m: Spec(("data", None)), m4)
    assert moved.mesh == m4
    for r in range(4):
        assert np.array_equal(moved.leaves(r)[0].numpy(), ref["rm1"][r])
    src, dst = _mesh((4, 2)), _mesh((2, 2))
    specs = {"w": Spec(("data", "model")), "v": Spec((None, "model")), "b": Spec((None,))}
    tree = {k: torch.from_numpy(ref[f"rm_{k}"]) for k in specs}
    moved = remesh(shard_tree(tree, specs, src), lambda m: specs, dst)
    for r in range(dst.size):
        for k, block in moved.ranks[r].items():
            assert np.array_equal(block.numpy(), ref[f"rm2_{k}"][r]), (k, r)


def test_remesh_round_trip_and_step():
    """A trained state from 4 ranks to 2 and back: bitwise each way; one
    step on the 2-rank mesh against one on the 4-rank mesh."""
    cfg, params, batch = _setup("qwen3-1.7b", False)
    m4, m2 = _mesh(), _mesh((2, 1))
    sp, so, sb = _place(cfg, params, batch, m4)
    tc = TrainConfig(**TRAIN)
    sp, so, _ = TR.make_train_step(cfg, tc, mesh=m4)(sp, so, sb)

    def plan(tree_specs_of):
        return lambda mesh: tree_specs_of(mesh)

    def pspecs(mesh):
        return SH.param_specs(cfg, params, mesh)

    def ospecs(mesh):
        return SH.opt_specs(cfg, so.ranks[0], mesh, pspecs(mesh))

    p2, o2 = remesh(sp, plan(pspecs), m2), remesh(so, plan(ospecs), m2)
    for a, b in ((p2, sp), (o2, so)):
        assert all(torch.equal(x, y) for x, y in zip(TT.leaves(gather_tree(a, "cpu")),
                                                     TT.leaves(gather_tree(b, "cpu"))))
    p4, o4 = remesh(p2, plan(pspecs), m4), remesh(o2, plan(ospecs), m4)
    for a, b in ((p4, sp), (o4, so)):
        for r in range(m4.size):
            assert all(torch.equal(x, y) for x, y in zip(a.leaves(r), b.leaves(r)))
    b2 = shard_tree(batch, SH.batch_specs(cfg, batch, m2), m2)
    p2, o2, met2 = TR.make_train_step(cfg, tc, mesh=m2)(p2, o2, b2)
    p4, o4, met4 = TR.make_train_step(cfg, tc, mesh=m4)(p4, o4, sb)
    # both steps compute the one gradient of the whole batch; only the clip's
    # sum over blocks differs, a relative change of the clip factor that
    # Adam's scale-free update carries at most in proportion
    for k in met4:
        assert abs(float(met2[k]) - float(met4[k])) <= 1e-5 * max(1.0, abs(float(met4[k]))), k
    for a, b in ((p2, p4), (o2, o4)):
        for x, y in zip(TT.leaves(gather_tree(a, "cpu")), TT.leaves(gather_tree(b, "cpu"))):
            assert float((x - y).abs().max()) <= 1e-5 * max(1.0, float(y.abs().max()))
    assert isinstance(p2, ShardedTree) and p2.mesh == m2
