"""The port's dry run (``repro_torch.launch.dryrun``), its roofline
(``repro_torch.roofline``) and the cost-mode switches
(``repro_torch.models.costmode``), against the JAX package where it has a
counterpart that runs in this process.

``repro.launch.dryrun`` is never imported here: at import it sets
``XLA_FLAGS`` to 512 forced host devices (``src/repro/launch/dryrun.py:1-6``).
Its ``_depths`` and ``_extrapolate`` are held to the reference's values,
written below with the lines they come from; ``model_flops`` and
``supports_cell`` to ``repro.roofline`` and ``repro.models.registry``.

Exact equality throughout: the counts are integers (FLOPs, bytes) carried
in float64 far below 2**53 at these sizes, and the seam bytes are sums of
block sizes.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import tree as TT  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, ShapeCell, TrainConfig  # noqa: E402
from repro_torch.core.sharding import NamedMesh, count_seams  # noqa: E402
from repro_torch.data.lm_tokens import TokenPipeline  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch.mesh import make_lm_mesh  # noqa: E402
from repro_torch.models import costmode  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models import sharding as SH  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.roofline import HW, collective_bytes, model_flops, roofline_terms  # noqa: E402
from repro_torch.state import shard_tree  # noqa: E402

pytestmark = [pytest.mark.torch]

#: ``_depths`` of the reference (src/repro/launch/dryrun.py:77-82): zamba2's
#: shared_attn_every periods, deepseek's leading dense layer + 1 and + 2,
#: else (2, 4)
REF_DEPTHS = {"deepseek-v2-236b": (2, 3), "qwen2-moe-a2.7b": (2, 4), "qwen3-1.7b": (2, 4),
              "qwen2-1.5b": (2, 4), "starcoder2-15b": (2, 4), "stablelm-3b": (2, 4),
              "paligemma-3b": (2, 4), "rwkv6-3b": (2, 4), "whisper-large-v3": (2, 4),
              "zamba2-1.2b": (6, 12)}
SMALL_MESH = ((2, 2), ("data", "model"))
TRAIN = dict(lr=1e-2, warmup=2, total_steps=10, compute_dtype="float32")


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _small(depth=2):
    return dataclasses.replace(ARCHS["qwen3-1.7b"].reduced(), n_layers=depth)


# ------------------------------------------------------------ the roofline
def test_model_flops_equal_reference():
    """n_params_total, n_params_active, tokens and model_flops equal the
    reference's on its own abstract parameters, for the ten architectures
    and the four shapes."""
    from repro.configs import ARCHS as JA
    from repro.configs import SHAPES as JS
    from repro.models import registry as JR
    from repro.roofline import model_flops as j_model_flops

    for arch in sorted(ARCHS):
        j_params = JR.abstract_params(JA[arch])
        params = TR.abstract_params(ARCHS[arch])
        for shape in SHAPES:
            assert model_flops(ARCHS[arch], SHAPES[shape], params) == \
                j_model_flops(JA[arch], JS[shape], j_params), (arch, shape)


def test_depths_extrapolate_and_skips_equal_reference():
    from repro.configs import ARCHS as JA
    from repro.configs import SHAPES as JS
    from repro.models import registry as JR

    assert {a: D._depths(c) for a, c in ARCHS.items()} == REF_DEPTHS
    # src/repro/launch/dryrun.py:88-91: the encoder cut with the decoder
    assert D._variant(ARCHS["whisper-large-v3"], 3).n_enc_layers == 3
    assert D._variant(ARCHS["qwen3-1.7b"], 3).n_enc_layers == 0
    # src/repro/launch/dryrun.py:94-100: va + (L − la)·(vb − va)/(lb − la),
    # a key missing on one side read as 0
    got = D._extrapolate({"x": 10, "y": 1}, {"x": 30}, 2, 4, 28)
    assert got == {"x": 270.0, "y": 1.0 + 26 * (0.0 - 1.0) / 2}
    skips = {(a, s) for a in ARCHS for s in SHAPES if not TR.supports_cell(ARCHS[a], SHAPES[s])[0]}
    j_skips = {(a, s) for a in JA for s in JS if not JR.supports_cell(JA[a], JS[s])[0]}
    assert skips == j_skips and len(skips) == 8


def test_roofline_terms_on_h100_peaks():
    assert HW == {"peak_flops": 989e12, "hbm_bw": 3.35e12, "link_bw": 900e9,
                  "hbm_bytes": 80e9}
    coll = {"all-gather": {"count": 2, "bytes": 450e9}, "total_bytes": 900e9}
    t = roofline_terms({"flops": 989e12 * 2, "bytes accessed": 3.35e12 * 0.5}, coll)
    assert (t["t_compute_s"], t["t_memory_s"], t["t_collective_s"]) == (2.0, 0.5, 1.0)
    assert t["dominant"] == "compute" and t["roofline_fraction_compute"] == 1.0
    t = roofline_terms({"flops": 0.0, "bytes accessed": 3.35e12 * 3}, coll)
    assert t["dominant"] == "memory" and t["roofline_fraction_compute"] == 0.0
    assert roofline_terms({}, coll)["dominant"] == "collective"
    assert collective_bytes()["total_bytes"] == 0


# ---------------------------------------------------------------- costmode
def test_costmode_switches():
    """Outside cost mode each switch returns its request; in cost mode the
    flash block grows to a divisor of the padded key length (FLOPs kept)
    and the chunk loop to at most MAX_CHUNK_COPIES chunks."""
    assert costmode.flash_block(512, 1500) == 512 and costmode.chunk_size(64, 4096) == 64
    with costmode.enabled():
        assert costmode.flash_block(512, 4096) == 4096
        assert costmode.flash_block(512, 32768) == 4096
        assert costmode.flash_block(512, 1500) == 1536  # 3 blocks of 512 → one of 1536
        assert costmode.flash_block(512, 100) == 512
        assert costmode.chunk_size(64, 4096) == 512
    assert not costmode.UNROLL and costmode.FLASH_BLOCK is None


def test_costmode_flops_same_at_flash_blocks():
    """In cost mode a train step's FLOPs are the same at flash blocks of 512
    and 4096 (reduced qwen3, 8 × 2048 tokens: 4 key blocks against 1)."""
    cfg = _small()
    cell = ShapeCell("t", 2048, 8, "train")
    plan = NamedMesh(*SMALL_MESH)
    got = {}
    for block in (512, 4096):
        with costmode.enabled(flash=block):
            built = D.build_cell(cfg, cell, plan)
            got[block] = D.count(built["fn"], *built["args"])
    assert got[512]["cost"]["flops"] == got[4096]["cost"]["flops"] > 0
    assert got[512]["ops"] > got[4096]["ops"]


def test_forward_outside_costmode_unchanged():
    """Outside cost mode (before and after a cost-mode scope) the forward
    is bitwise the same: reduced qwen3 (flash) and rwkv6 (the chunk loop)."""
    for arch in ("qwen3-1.7b", "rwkv6-3b"):
        cfg = ARCHS[arch].reduced()
        api = TR.build(cfg, compute_dtype=torch.float32, device="cpu")
        params = api.init()
        batch = TokenPipeline(cfg.vocab, 40, 2, device="cpu").batch(0)
        with torch.no_grad():
            before = api.loss(params, batch)[0]
            with costmode.enabled():
                api.loss(params, batch)
            after = api.loss(params, batch)[0]
        assert torch.equal(before, after), arch


# -------------------------------------------------------------- the counts
def test_extrapolated_count_equals_direct():
    """Reduced qwen3 on a (data 2, model 2) mesh: the counts at depths 2 and
    4 extrapolated to 6 equal the direct count at depth 6, exactly."""
    cell = ShapeCell("t", 64, 8, "train")
    plan = NamedMesh(*SMALL_MESH)
    got = {}
    for depth in (2, 4, 6):
        built = D.build_cell(_small(depth), cell, plan)
        got[depth] = D.count(built["fn"], *built["args"])
    assert D._extrapolate(got[2]["cost"], got[4]["cost"], 2, 4, 6) == got[6]["cost"]
    for kind in ("all-gather", "all-reduce", "reduce-scatter"):
        assert D._extrapolate(got[2]["collectives"][kind], got[4]["collectives"][kind],
                              2, 4, 6) == got[6]["collectives"][kind], kind


def test_seam_bytes_real_step_equal_fake_and_specs():
    """One real sharded step on a (data 2, model 2) mesh of CPU logical
    shards moves, at rank 0's seams, the bytes the fake run (rank 0's
    program alone) counts and the specs give; rank 0's argument bytes are
    its real blocks'. Each rank computes its share (the dense family's
    step): every leaf that ``data`` splits is gathered and its gradient
    reduce-scattered (the tied embedding twice), and the FLOPs counted on
    meta for rank 0, times the four ranks, equal FlopCounterMode on the
    real step."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = _small()
    cell = ShapeCell("t", 16, 8, "train")
    tcfg = TrainConfig(**TRAIN)
    built = D.build_cell(cfg, cell, NamedMesh(*SMALL_MESH), tcfg=tcfg)
    fake = D.count(built["fn"], *built["args"])

    mesh = make_lm_mesh(*SMALL_MESH, devices=("cpu",) * 4)
    params = TR.build(cfg, compute_dtype=torch.float32, device="cpu").init()
    opt = adamw_init(params)
    batch = TokenPipeline(cfg.vocab, cell.seq_len, cell.global_batch, device="cpu").batch(0)
    pspecs = SH.param_specs(cfg, params, mesh)
    sp = shard_tree(params, pspecs, mesh)
    so = shard_tree(opt, SH.opt_specs(cfg, opt, mesh, pspecs), mesh)
    sb = shard_tree(batch, SH.batch_specs(cfg, batch, mesh), mesh)
    arg_bytes = sum(D._alloc(x.numel() * x.element_size())
                    for st in (sp, so, sb) for x in st.leaves(0))
    step = TR.make_train_step(cfg, tcfg, mesh=mesh)
    with count_seams() as real, FlopCounterMode(display=False) as fc:
        step(sp, so, sb)
    assert real == fake["collectives"] == built["coll"]
    fsdp = sum(1 for spec in sp.spec_leaves() if "data" in spec) + cfg.tie_embed
    assert real["total_bytes"] > 0 and real["reduce-scatter"]["count"] == 2 * fsdp
    assert arg_bytes == built["arg_bytes"]
    assert fc.get_total_flops() == mesh.size * fake["cost"]["flops"]


def test_run_cell_full_scale(tmp_path, monkeypatch):
    """qwen3-1.7b decode_32k on the single-pod mesh at full scale writes a
    record that passes the reference's own checks
    (``tests/test_system_properties.py``): t_compute_s > 0,
    model_flops > 0, dominant among the three terms."""
    monkeypatch.setattr(D, "RESULTS", tmp_path)
    rec = D.run_cell("qwen3-1.7b", "decode_32k", "single", force=True)
    assert rec["status"] == "ok", rec.get("error")
    on_disk = json.loads((tmp_path / "qwen3-1.7b__decode_32k__single.json").read_text())
    r = on_disk["roofline"]
    assert r["t_compute_s"] > 0 and r["model_flops"] > 0
    assert r["dominant"] in ("compute", "memory", "collective")
    assert on_disk["sharded_step"] is False and on_disk["n_chips"] == 1
    assert on_disk["memory"]["total_bytes_per_device"] == \
        on_disk["memory"]["argument_size_in_bytes"] + on_disk["memory"]["temp_size_in_bytes"]
    assert on_disk["fits"] == (on_disk["memory"]["total_bytes_per_device"] <= 80e9)
    # the direct full-depth count and the extrapolated one agree on FLOPs
    assert on_disk["cost"]["flops"] == pytest.approx(on_disk["cost_full_depth"]["flops"],
                                                     rel=1e-12)
    skipped = D.run_cell("qwen3-1.7b", "long_500k", "single", force=True)
    assert skipped["status"] == "skipped"
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "qwen3-1.7b__decode_32k__single.json", "qwen3-1.7b__long_500k__single.json"]


def test_rank0_bytes_match_planned_blocks():
    """``rank0_bytes`` on the production mesh: the planner's blocks, from the
    ``meta`` trees, as ``core.sharding.block_slices`` cuts them."""
    from repro_torch.core.sharding import block_slices
    from repro_torch.launch.mesh import make_production_mesh

    cfg = ARCHS["qwen3-1.7b"]
    mesh = make_production_mesh()
    params = TR.abstract_params(cfg)
    specs = SH.param_specs(cfg, params, mesh)
    want = sum(D._alloc(x[block_slices(x.shape, sp, mesh, 0)].numel() * x.element_size())
               for x, sp in zip(TT.leaves(params), TT.leaves(specs)))
    assert D.rank0_bytes(params, specs, mesh) == want
    assert want < sum(x.numel() * 4 for x in TT.leaves(params)) / 16
    assert np.isfinite(want)
