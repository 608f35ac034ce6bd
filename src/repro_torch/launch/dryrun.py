"""Dry run: every (arch × shape × mesh) cell counted on ``meta`` tensors,
nothing allocated on any device (the counterpart of
``src/repro/launch/dryrun.py``).

For each cell this builds the port's step (the sharded train step of
``registry.make_train_step(cfg, TrainConfig(grad_accum=4), mesh=)`` on the
production mesh for train shapes, its ranks ``meta`` devices; the
single-device prefill or decode step for inference shapes: the port has
no sharded serving step), runs it on the ``meta`` trees of
``registry.abstract_*`` and ``input_specs`` under :class:`Counter`, and
records:

  * ``memory``: a device's working set, the reference's "per-chip
    working set". On the production mesh a device holds one rank, so it is
    rank 0's: its blocks of the parameters, the optimizer state and the
    batch from the planner's specs, and the peak of live bytes the step
    allocates, each allocation rounded to the CUDA caching allocator's 512
    bytes. For the dense and vlm families the step computes rank 0's share
    (``models/spmd.py``): a layer's gathered blocks, the layer inputs remat
    keeps, the rank's rows' activations and its vocabulary block of the
    logits, and block-sized fp32 gradients. For the other families it is
    the gathered step: the compute copy, the gathered batch, the whole
    gradient, the activations and rank 0's update. On a mesh of logical
    shards of one device (``count(..., every_rank=True)``) every rank's
    blocks and allocations are the device's. ``fits`` holds the total
    against the card's 80 GB;
  * ``cost``: FLOPs as ``torch.utils.flop_counter.FlopCounterMode`` counts
    them (its ``flop_registry``, its decompositions), ``bytes accessed``
    (each op's input and output bytes: the eager program's own traffic;
    XLA's count is after fusion, so the two are not the same quantity) and
    ``transcendentals`` (the elements of exp, log, sqrt, tanh and kin);
  * ``collectives``: the bytes rank 0 sends and receives at the step's
    seams (``core.sharding.move``, ``count_seams()``), which
    ``roofline.collective_bytes`` derives from the specs as well;
  * ``roofline``: the three terms on the H100's peaks.

Only rank 0's work is counted. The step that computes each rank's share is
the same program on every rank, on blocks of one shape, so on the
production mesh its count runs rank 0's program alone
(``core.sharding.lead_rank_only``): its collectives take rank 0's blocks
for the other ranks' and make the moves rank 0 would make, with the code
that trains. The gathered step marks each rank's part
(``core.sharding.on_rank``), and the counter runs the other ranks' ops on
the shapes alone. Every rank of the production mesh shares one tree of
``meta`` blocks (there is no data to keep apart).

Cost is extrapolated to full depth from two reduced depths (``_depths``),
counted in cost mode (``models.costmode``), as the reference does; the
reference because its cost analysis counts a loop body once, the port
because the reduced depths count fast. The full-depth step is run once,
for memory, and its direct count is kept beside (``cost_full_depth``).

Prefill and decode cells run the single-device step on the cell's global
batch (``"sharded_step": false``), with the planner's per-rank argument
bytes beside it; ``fits`` is judged on the one device that runs it.

Results land in ``runs/dryrun_torch/<arch>__<shape>__<mesh>.json``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Several cells are counted at once, each in a process of its own, one a
core (the cells are independent).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import traceback
import weakref
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from .. import tree as T
from ..configs import ARCHS, SHAPES, TrainConfig
from ..core.sharding import count_seams, current_rank, lead_rank_only
from ..models import costmode
from ..models import registry as R
from ..models import sharding as SH
from ..models import spmd as SPMD
from ..obs import MonotonicClock
from ..roofline import HW, collective_bytes, roofline_report
from ..state import ShardedTree
from .mesh import make_lm_mesh, make_production_mesh

RESULTS = Path(__file__).resolve().parents[3] / "runs" / "dryrun_torch"

_CLK = MonotonicClock()  # the obs timing seam — no raw perf_counter (RPR003)
_ALLOC = 512  # the CUDA caching allocator's block granularity
_TRANSCENDENTAL = frozenset({
    "exp", "exp2", "expm1", "log", "log1p", "log2", "log10", "sqrt", "rsqrt", "tanh",
    "sigmoid", "sin", "cos", "erf", "erfinv", "silu", "gelu", "softplus", "_softmax",
    "_log_softmax", "pow", "_foreach_sqrt", "_foreach_exp"})
# in-place ops whose metadata never changes: on a repeat of their key the
# counter returns the mutated argument without running the meta kernel
_MUTATE_CACHED = frozenset({
    "copy_", "zero_", "fill_", "index_put_", "_index_put_impl_", "index_copy_", "index_add_",
    "scatter_", "scatter_add_", "masked_fill_", "normal_", "uniform_"})
_QUERY = frozenset({
    "is_contiguous", "is_strides_like_format", "is_non_overlapping_and_dense", "size",
    "sym_size", "stride", "sym_stride", "storage_offset", "sym_storage_offset", "numel",
    "sym_numel", "dim", "sym_is_contiguous", "layout", "device"})


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _key(x):
    if isinstance(x, torch.Tensor):
        return (x.shape, x.stride(), x.dtype, x.device)
    if isinstance(x, (list, tuple)):
        return tuple(_key(y) for y in x)
    if isinstance(x, dict):
        return tuple((k, _key(v)) for k, v in x.items())
    return (type(x), x)


def _spec(out):
    if isinstance(out, torch.Tensor):
        return ("t", tuple(out.shape), out.stride(), out.dtype, out.device)
    if isinstance(out, (list, tuple)):
        return (type(out), [_spec(y) for y in out])
    return ("v", out)


def _build(spec):
    if spec[0] == "t":
        return torch.empty_strided(spec[1], spec[2], dtype=spec[3], device=spec[4])
    if spec[0] == "v":
        return spec[1]
    return spec[0](_build(s) for s in spec[1])


class _OpInfo:
    __slots__ = ("kind", "decomposes", "flop_fn", "transcendental", "multi", "mirror",
                 "_learnt")

    def __init__(self, func):
        schema = func._schema
        name = func._overloadpacket.__name__
        mutable = any(a.alias_info is not None and a.alias_info.is_write
                      for a in schema.arguments)
        aliased = [r.alias_info for r in schema.returns if r.alias_info is not None]
        if name in _QUERY:
            kind = "query"
        elif mutable or any(a.is_write for a in aliased):
            cached = (name in _MUTATE_CACHED or name.startswith("_foreach_")
                      or torch.Tag.pointwise in func.tags)
            kind = "mutate" if cached else "native"
        elif aliased:
            kind = "view"
        elif torch.Tag.nondeterministic_seeded in func.tags or \
                torch.Tag.data_dependent_output in func.tags:
            kind = "native"
        else:
            kind = "fresh"
        self.kind = kind
        self.decomposes = kind != "query" and torch._C._dispatch_has_kernel_for_dispatch_key(
            func.name(), torch._C.DispatchKey.CompositeImplicitAutograd)
        self.flop_fn = flop_registry.get(func._overloadpacket)
        self.transcendental = name in _TRANSCENDENTAL
        self.multi = name.startswith("_foreach_") and kind in ("fresh", "mutate")
        self.mirror = None   # how another rank's call is answered (``learn``)
        self._learnt = False

    def learn(self, record, out, args):
        """One run of a multi-tensor op: how another rank's call may be
        answered without running it. A mutating op by where its outputs lie
        among its arguments; a fresh one by its first argument, when every
        output had the shape, strides and dtype of that list's tensor. A run
        that answers otherwise turns the shortcut off for good."""
        if self.kind == "mutate":
            this = record if record[0] != "spec" else None
        else:
            first = args[0] if args and isinstance(args[0], (list, tuple)) else None
            same = first is not None and len(first) == len(out) and all(
                o.shape == a.shape and o.stride() == a.stride() and o.dtype == a.dtype
                for o, a in zip(out, first))
            this = ("mirror",) if same else None
        if self._learnt and this != self.mirror:
            this = None
        self.mirror, self._learnt = this, True


class Counter(TorchDispatchMode):
    """Counts a step run on ``meta`` tensors: FLOPs (``flop_registry``, with
    ``FlopCounterMode``'s decompositions), bytes accessed (each op's tensor
    inputs and outputs; views move nothing), transcendentals, and the live
    bytes of the storages the step allocates (their ``peak``). Only rank
    0's work and work outside any ``on_rank`` scope count, or with
    ``every_rank`` every rank's (logical shards: one device does it all);
    ``flops_all`` adds every rank's FLOPs.

    A meta kernel is run once for each distinct op and argument metadata;
    a repeat builds its outputs from the first's shapes (an in-place op
    returns its mutated argument), which makes a step of many layers and
    ranks fast to count."""

    def __init__(self, alloc: int = _ALLOC, every_rank: bool = False):
        super().__init__()
        self.every_rank = every_rank
        self.flops = 0
        self.flops_all = 0
        self.bytes = 0
        self.transcendentals = 0
        self.live = 0
        self.peak = 0
        self.ops = 0
        self._alloc = alloc
        self._info: dict = {}
        self._cache: dict = {}
        self._seen: set = set()

    # ------------------------------------------------------------ storage
    def _free(self, ident, n):
        self._seen.discard(ident)
        self.live -= n

    def _track(self, out):
        for t in _tensors(out):
            st = t.untyped_storage()
            ident = id(st)
            if ident in self._seen:
                continue
            n = st.nbytes()
            n = -(-n // self._alloc) * self._alloc if n else 0
            self._seen.add(ident)
            weakref.finalize(st, self._free, ident, n)
            self.live += n
        self.peak = max(self.peak, self.live)

    # ----------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        info = self._info.get(func)
        if info is None:
            info = self._info[func] = _OpInfo(func)
        if info.kind == "query":
            return func(*args, **kwargs)
        if info.decomposes:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        counted = self.every_rank or current_rank() in (None, 0)
        kind = info.kind
        if not counted and info.mirror is not None:
            # another rank's multi-tensor op: only its shapes matter, and its
            # earlier runs gave outputs shaped as its first argument
            out = (self._pick(info.mirror, args, kwargs) if kind == "mutate"
                   else type(args[0])(args[0]))
            if info.flop_fn:
                self.flops_all += info.flop_fn(*args, **kwargs, out_val=out)
            return out
        if kind in ("view", "native"):
            out = func(*args, **kwargs)
        else:
            key = (func, _key(args), _key(kwargs) if kwargs else None)
            hit = self._cache.get(key)
            if hit is None:
                out = func(*args, **kwargs)
                self._cache[key] = (self._where(out, args, kwargs) if kind == "mutate"
                                    else _spec(out))
                if info.multi:
                    info.learn(self._cache[key], out, args)
            elif kind == "mutate":
                out = self._pick(hit, args, kwargs)
            else:
                out = _build(hit)
        flops = info.flop_fn(*args, **kwargs, out_val=out) if info.flop_fn else 0
        self.flops_all += flops
        if not counted:
            return out
        self.ops += 1
        self.flops += flops
        if kind != "view":
            self.bytes += sum(_nbytes(t) for t in _tensors(args)) \
                + sum(_nbytes(t) for t in _tensors(kwargs)) \
                + sum(_nbytes(t) for t in _tensors(out))
            if info.transcendental:
                self.transcendentals += sum(t.numel() for t in _tensors(out)) if out is not None \
                    else sum(t.numel() for t in _tensors(args[0]))
        if kind in ("fresh", "native"):
            self._track(out)
        return out

    @staticmethod
    def _where(out, args, kwargs):
        """Where a mutating op's outputs are among its arguments."""
        def find(t):
            for i, a in enumerate(args):
                if a is t:
                    return ("a", i)
            for k, a in kwargs.items():
                if a is t:
                    return ("k", k)
            raise LookupError

        try:
            if isinstance(out, torch.Tensor):
                return ("one", find(out))
            if isinstance(out, (list, tuple)) and not out:
                return ("empty", type(out))
            if isinstance(out, (list, tuple)):
                return ("many", type(out), [find(t) for t in out])
        except LookupError:
            pass
        return ("none",) if out is None else ("spec", _spec(out))

    @staticmethod
    def _pick(where, args, kwargs):
        def get(loc):
            return args[loc[1]] if loc[0] == "a" else kwargs[loc[1]]

        tag = where[0]
        if tag == "none":
            return None
        if tag == "one":
            return get(where[1])
        if tag == "empty":
            return where[1]()
        if tag == "many":
            return where[1](get(loc) for loc in where[2])
        return _build(where[1])

    def result(self) -> dict:
        return {"flops": float(self.flops), "bytes accessed": float(self.bytes),
                "transcendentals": float(self.transcendentals)}


def count(fn, *args, every_rank: bool = False) -> dict:
    """``fn(*args)`` run under :class:`Counter` (``every_rank``: a device
    holding every rank) and ``count_seams()``: {"cost", "flops_all",
    "peak_bytes", "collectives", "ops", "out"}."""
    cnt = Counter(every_rank=every_rank)
    with count_seams() as seams, cnt:
        out = fn(*args)
    return {"cost": cnt.result(), "flops_all": float(cnt.flops_all), "peak_bytes": cnt.peak,
            "collectives": seams, "ops": cnt.ops, "out": out}


# ------------------------------------------------------------------ cells
def _depths(cfg):
    """Two reduced depths for the cost extrapolation, chosen to keep the
    arch's per-layer structure: deepseek keeps its leading dense layer,
    zamba2 spans whole (mamba×6 + shared-attn site) periods."""
    if cfg.family == "hybrid":
        e = cfg.shared_attn_every
        return e, 2 * e
    if cfg.moe is not None and cfg.n_dense_layers:
        return cfg.n_dense_layers + 1, cfg.n_dense_layers + 2
    return 2, 4


def _variant(cfg, depth):
    kw = {"n_layers": depth}
    if cfg.n_enc_layers:
        kw["n_enc_layers"] = depth
    return dataclasses.replace(cfg, **kw)


def _extrapolate(fa: dict, fb: dict, la: int, lb: int, layers: int) -> dict:
    out = {}
    for k in set(fa) | set(fb):
        va, vb = float(fa.get(k, 0.0)), float(fb.get(k, 0.0))
        slope = (vb - va) / (lb - la)
        out[k] = va + (layers - la) * slope
    return out


def _block_shape(shape, spec, mesh) -> tuple:
    return tuple(d // mesh.axis_size(e) for d, e in zip(shape, spec))


def _alloc(n: int) -> int:
    return -(-n // _ALLOC) * _ALLOC


def rank0_bytes(tree, specs, mesh) -> int:
    """Rank 0's bytes of ``tree`` laid out by ``specs`` on ``mesh``, each
    block rounded to the allocator's granularity."""
    return sum(_alloc(math.prod(_block_shape(x.shape, sp, mesh)) * x.element_size())
               for x, sp in zip(T.leaves(tree), T.leaves(specs)))


def _meta_sharded(tree, specs, mesh, every_rank: bool = False) -> ShardedTree:
    """``tree`` (``meta``) placed on ``mesh`` by ``specs``: one tree of
    ``meta`` blocks, shared by every rank (or, ``every_rank``, a tree a
    rank: logical shards whose every rank runs)."""
    leaves = T.leaves(tree)

    def one():
        return T.unflatten_like(tree, [
            torch.empty(_block_shape(x.shape, sp, mesh), dtype=x.dtype, device="meta")
            for x, sp in zip(leaves, T.leaves(specs))])

    ranks = [one() for _ in range(mesh.size)] if every_rank else [one()] * mesh.size
    return ShardedTree(mesh, specs, ranks, [tuple(x.shape) for x in leaves])


def build_cell(cfg, shape, mesh, serve_dtype=torch.bfloat16, tcfg=None,
               every_rank: bool = False) -> dict:
    """One dry-run cell's step and its ``meta`` arguments: {"fn", "args",
    "params", "arg_bytes" (a device's), "planned_arg_bytes" (a serving
    cell's per-rank bytes under the planner), "sharded", "spmd" (the step
    computes each rank's share), "n_chips", "coll" (the crossings the
    specs give)}. ``shape`` names a cell of ``SHAPES`` or is a
    ``ShapeCell``; ``mesh`` is a planning mesh (the production one); a
    train cell runs on its ranks as ``meta`` devices: rank 0's program
    alone where the step is SPMD, or with ``every_rank`` every rank, each
    with its own blocks, on one device (logical shards)."""
    cell = SHAPES[shape] if isinstance(shape, str) else shape
    batch_abs = R.input_specs(cfg, cell)
    bspecs = SH.batch_specs(cfg, batch_abs, mesh)
    if cell.kind == "train":
        tcfg = tcfg or TrainConfig(grad_accum=4)  # 4 microbatches: activations ÷4
        run_mesh = make_lm_mesh(tuple(mesh.shape.values()), mesh.axis_names,
                                devices=("meta",) * mesh.size)
        params_abs = R.abstract_params(cfg, getattr(torch, tcfg.param_dtype))
        opt_abs = R.abstract_opt_state(params_abs, tcfg.master_fp32)
        pspecs = SH.param_specs(cfg, params_abs, run_mesh)
        ospecs = SH.opt_specs(cfg, opt_abs, run_mesh, pspecs)
        bspecs = SH.batch_specs(cfg, batch_abs, run_mesh)
        args = tuple(_meta_sharded(tree, specs, run_mesh, every_rank) for tree, specs in
                     ((params_abs, pspecs), (opt_abs, ospecs), (batch_abs, bspecs)))
        arg_bytes = (rank0_bytes(params_abs, pspecs, run_mesh)
                     + rank0_bytes(opt_abs, ospecs, run_mesh)
                     + rank0_bytes(batch_abs, bspecs, run_mesh))
        device_bytes = sum(_alloc(_nbytes(x)) for st in args for r in range(run_mesh.size)
                           for x in st.leaves(r)) if every_rank else arg_bytes
        step = R.make_train_step(cfg, tcfg, mesh=run_mesh)
        spmd = SPMD.splits(cfg)
        fn = step if every_rank or not spmd else _lead(step)
        return {"fn": fn, "args": args, "params": params_abs, "arg_bytes": device_bytes,
                "planned_arg_bytes": arg_bytes, "sharded": True, "spmd": spmd,
                "n_chips": mesh.size,
                "coll": collective_bytes(run_mesh, params_abs, pspecs, batch_abs, bspecs, cfg=cfg,
                                         tcfg=tcfg)}

    params_abs = R.abstract_params(cfg, serve_dtype)
    pspecs = SH.param_specs(cfg, params_abs, mesh)
    if cell.kind == "prefill":
        fn = R.make_prefill_step(cfg, t_max=cell.seq_len, device="meta")
        args = (params_abs, batch_abs)
        planned = rank0_bytes(params_abs, pspecs, mesh) + rank0_bytes(batch_abs, bspecs, mesh)
    else:  # decode: one new token against a seq_len-deep cache
        fn = R.make_decode_step(cfg, device="meta")
        cache_abs = R.abstract_cache(cfg, cell.global_batch, cell.seq_len)
        args = (params_abs, batch_abs, cache_abs)
        planned = (rank0_bytes(params_abs, pspecs, mesh) + rank0_bytes(batch_abs, bspecs, mesh)
                   + rank0_bytes(cache_abs, SH.cache_specs(cfg, cache_abs, mesh), mesh))
    arg_bytes = sum(_alloc(_nbytes(x)) for a in args for x in T.leaves(a))
    return {"fn": fn, "args": args, "params": params_abs, "arg_bytes": arg_bytes,
            "planned_arg_bytes": planned, "sharded": False, "spmd": False, "n_chips": 1,
            "coll": collective_bytes()}


def _lead(step):
    """``step`` run as rank 0's program alone (``core.sharding.lead_rank_only``)."""
    def lead_step(*args):
        with lead_rank_only():
            return step(*args)

    return lead_step


def memory_record(arg_bytes: int, peak_bytes: int, planned: int | None = None) -> dict:
    """The reference's ``memory`` keys for rank 0 (nothing is donated:
    the step updates its arguments in place, so output and alias are 0)."""
    out = {"argument_size_in_bytes": int(arg_bytes), "output_size_in_bytes": 0,
           "temp_size_in_bytes": int(peak_bytes), "alias_size_in_bytes": 0,
           "total_bytes_per_device": int(arg_bytes + peak_bytes)}
    if planned is not None:
        out["planned_argument_bytes_per_rank"] = int(planned)
    return out


def _count_cell(cfg, shape, mesh, cost_mode=False):
    with costmode.enabled() if cost_mode else contextlib.nullcontext():
        built = build_cell(cfg, shape, mesh)
        got = count(built["fn"], *built["args"])
    return built, got


def _coll_sum(coll: dict) -> dict:
    coll = {k: v for k, v in coll.items() if isinstance(v, dict)}
    coll["total_bytes"] = sum(v["bytes"] for v in coll.values())
    return coll


def run_cell(arch: str, shape: str, mesh_kind: str, force=False) -> dict:
    RESULTS.mkdir(parents=True, exist_ok=True)
    out_path = RESULTS / f"{arch}__{shape}__{mesh_kind}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())

    cfg = ARCHS[arch]
    cell = SHAPES[shape]
    ok, reason = R.supports_cell(cfg, cell)
    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind, "ts": time.time()}
    if not ok:
        rec.update(status="skipped", reason=reason)
        out_path.write_text(json.dumps(rec, indent=1))
        return rec

    mesh = make_production_mesh(multi_pod=mesh_kind == "multi")
    try:
        t0 = _CLK.now()
        built, full = _count_cell(cfg, shape, mesh)
        t_full = _CLK.now() - t0
        la, lb = _depths(cfg)
        _, ga = _count_cell(_variant(cfg, la), shape, mesh, cost_mode=True)
        _, gb = _count_cell(_variant(cfg, lb), shape, mesh, cost_mode=True)
        cost = _extrapolate(ga["cost"], gb["cost"], la, lb, cfg.n_layers)
        coll = _coll_sum({k: _extrapolate(ga["collectives"][k], gb["collectives"][k], la, lb,
                                          cfg.n_layers)
                          for k in ga["collectives"] if isinstance(ga["collectives"][k], dict)})
        flops_all = _extrapolate({"f": ga["flops_all"]}, {"f": gb["flops_all"]}, la, lb,
                                 cfg.n_layers)["f"]
        mem = memory_record(built["arg_bytes"], full["peak_bytes"], built["planned_arg_bytes"])
        roof = roofline_report(cost, coll, cfg, cell, built["params"], built["n_chips"],
                               global_flops=None if built["spmd"] else flops_all)
        rec.update(
            status="ok",
            n_chips=built["n_chips"],
            mesh_ranks=mesh.size,
            sharded_step=built["sharded"],
            rank_share_step=built["spmd"],
            count_s=round(_CLK.now() - t0, 2),
            full_depth_s=round(t_full, 2),
            memory=mem,
            fits=mem["total_bytes_per_device"] <= HW["hbm_bytes"],
            cost=cost,
            cost_full_depth=full["cost"],
            collectives=coll,
            collectives_from_specs=built["coll"],
            depth_extrapolation={"la": la, "lb": lb, "layers": cfg.n_layers},
            roofline=roof,
        )
    except Exception as e:  # a cell that fails is recorded, and the grid goes on
        rec.update(status="error", error=repr(e), trace=traceback.format_exc()[-4000:])
    out_path.write_text(json.dumps(rec, indent=1, default=float))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(a, s) for a in ARCHS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]

    failures = 0
    t0 = _CLK.now()
    todo = [(arch, shape, mk, args.force) for arch, shape in cells for mk in meshes]
    for rec in _records(todo):
        status = rec["status"]
        extra = ""
        if status == "ok":
            r = rec["roofline"]
            gib = rec["memory"]["total_bytes_per_device"] / 2**30
            extra = (f" dom={r['dominant']} tc={r['t_compute_s']:.3e}s"
                     f" tm={r['t_memory_s']:.3e}s tx={r['t_collective_s']:.3e}s"
                     f" mem={gib:.1f}GiB fits={rec['fits']} count={rec['count_s']:.1f}s")
        elif status == "error":
            failures += 1
            extra = " " + rec["error"][:120]
        print(f"[dryrun] {rec['arch']:20s} {rec['shape']:12s} {rec['mesh']:6s} {status}{extra}",
              flush=True)
    print(f"[dryrun] {len(todo)} cells in {_CLK.now() - t0:.1f} s, {failures} errors",
          flush=True)
    return 1 if failures else 0


def _one(arch, shape, mk, force):
    torch.set_num_threads(1)
    return run_cell(arch, shape, mk, force=force)


def _records(todo):
    """Each cell's record, in ``todo``'s order: one cell here, several in
    worker processes, one a core (spawned: no state is shared)."""
    jobs = min(len(todo), os.cpu_count() or 1)
    if jobs <= 1:
        for cell in todo:
            yield run_cell(*cell[:3], force=cell[3])
        return
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=jobs, mp_context=ctx) as pool:
        for fut in [pool.submit(_one, *cell) for cell in todo]:
            yield fut.result()


if __name__ == "__main__":
    sys.exit(main())
