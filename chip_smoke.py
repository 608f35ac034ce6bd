#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one CUDA card and check them.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. build: compile ``src/repro_torch/csrc/*.cu`` with nvcc for sm_90a;
2. Gaussian kernels: each hand kernel against its plain PyTorch version
   on the card, at the shapes the Gaussian main path gives it on the
   paper's NCI-60 workload (n = 1190 variables, m = 47 samples, density
   0.02, α = 0.01; seeded Gaussian-DAG stand-in data): corr (plus the
   §5.6 shape m = 10000, n = 1000 and a ragged m = 1003, n = 517; each
   bitwise symmetric and bitwise equal across two calls, and timed in
   turns with ``torch.matmul``, also inside a CUDA graph), level0 on C
   (both entries exact: the adjacency alone against ``levels.level0``,
   the fused level-0 span (adjacency, level-0 sepsets, max degree; the
   driver's one level-0 launch) against ``levels.level0_span``, here and
   at §5.6's C; timed, with and without a CUDA graph, beside the seven-op
   span it replaced), level1 on the level-0 adjacency (with the 32-k
   steps its pairs' own walks need, the steps 16×16 tiles of pairs walking k in
   lockstep (the earlier level-1 design) ran, and
   the kernel's 128-k warp steps), cholinv and cisweep on the first ℓ = 2
   chunk, the fused S-kernel (skernel: C, neighbour lists and the first
   rank, one launch a chunk) on the same chunk, its winners bitwise those
   of cholinv + cisweep on ``levels.gather_s``'s output and timed beside
   them, the gather and ``plan_sets``, sgrid's fused entry (the "S-grid"
   path: C, neighbour lists and the first rank, no gather) on the first
   level-1 launch of "S-grid", timed beside ``levels.gather_s`` and the
   gathered entry on the same launch, and sgrid's gathered entry on
   seeded SPD launches at ℓ = 3 and ℓ = 8. Decisions (sgrid, skernel:
   winners) may differ only in cells whose
   decision moves within τ ± 1e-4 (found by re-running the plain version
   at τ ± 1e-4); cholinv must agree to rtol 1e-5, atol 1e-6; corr to
   atol 2e-6;
3. Gaussian end to end: ``pc(x)`` on NCI-60 with the launch counts reset
   just before and read just after (every kernel of the path must have
   launched: corr, level0 once, level1 and skernel once a chunk at ℓ ≥ 2,
   and neither cholinv nor cisweep), its level-0 span's seconds, a
   float64 certificate of every recorded sepset, the same run with the
   reference's two kernels a chunk
   (``chunk_fn_s=ops.chunk_s_two_launch``: cholinv and cisweep once a
   chunk, no skernel) bitwise equal to it, and
   equality with the port's own CPU run on an n = 200 instance fed the
   same C, under "auto" and under "S-grid". A test whose float64
   statistic lies past τ by less than the forward-error bound of its fp32
   evaluation (see ``z_of``) is not decidable in fp32, the reference's
   arithmetic as much as the port's; the certificate counts such tests
   and does not fail them. Then ``pc(x, engine=e)`` for "S", "E",
   "S-grid" and "S" at ``pipeline_depth=3``, each with its own counts
   (S-grid: one sgrid launch per planned launch and no chunked kernel;
   S and E: no kernel but corr and level0), compared with "auto" (every
   differing edge explained by the band or the fp32 bound; for "E" the
   skeleton only, as its sets rank differently) and certified;
   the paper's §5.6 instance (n = 1000, m = 10 000, density 0.1, α = 0.01,
   seed 0): sgrid's fused entry on its first ℓ = 2 launch and skernel on
   "auto"'s first ℓ = 2 chunk, then "auto" (skernel once a chunk at
   ℓ ≥ 2) and "S-grid" with per-level chunks and spans, "S-grid" against
   "auto" and certified;
4. discrete kernel: gsq against its plain version, bitwise, at the level-0
   shape of a bnlearn-PIGS-shaped stand-in (n = 441 ternary variables,
   m = 5000 samples, density 0.0061 ≈ 592 arcs, α = 0.01, seeded
   Dirichlet-CPT DAG data) and on the first chunk of every level ℓ = 1…5
   (K = 27 … 2187), each level's adjacency from running the one before;
5. discrete end to end: ``pc(x, test="discrete")`` on that stand-in with
   the counts reset just before and read just after (gsq must have
   launched), per-level times, and a float64 certificate (scipy's χ²
   tail) of every recorded sepset at ℓ ≥ 1: p ≥ α, except p within
   |p/α − 1| ≤ 1e-4 (the p band) or within the first-order error bound of
   the fp32 G² (see ``g2_of``), both counted; then equality with the
   port's CPU run on an n = 40 instance outside the p band, and with the
   float64 serial oracle's skeleton on an n = 12 instance;
6. batch (``repro_torch.batch``; each path with the counts reset just
   before it and read just after): (a) the reference's many-graph workload
   (``benchmarks/pc_batch.py`` FULL_CONFIGS["sparse"]: B = 64, n = 96,
   m = 3000, density 0.015, α = 0.01, cap 3): ``plan_schedule``, then
   ``pc_scan_batch`` on the schedule, one CUDA graph recorded once and
   replayed (the replays' launches equal the graph's, level0 once a lane),
   every lane bitwise ``pc_from_corr(engine="S-kernel")`` at the same cap,
   graphs/s beside the sequential loop of ``pc_from_corr(engine="auto")``,
   ``alpha_sweep`` over four α on lane 0's C (each lane bitwise
   ``pc_scan`` at its α) and four lanes against the port's CPU run
   outside the τ band; (b) ``bootstrap_pc`` on NCI-60 (8 replicates, one
   graph a level), its spans, every replicate bitwise "S-kernel" on its
   own C, ``edge_freq`` the replicates' mean, the CPDAG that of a vote
   recomputed by a scatter of the recorded ids, corr, level0 and skernel
   launched 8, 8 and the planned times; (c) ``pc(codes, test="discrete",
   engine="scan")`` on the PIGS stand-in, bitwise the "G2-kernel" host
   loop at the same cap (2 where 3 levels would sweep more than 10 000
   steps), gsq launched. Beside each time, the card's name and power
   limit;
7. serving and the launchers (``repro_torch.launch``, ``repro_torch.serve``):
   (a) ``python -m repro_torch.launch.pc_run --dataset NCI-60`` in a
   subprocess, its edges and levels phase 3's "auto"'s; ``pc_run.main``
   with ``--batch 64`` on the batch cell's lanes, its schedule that of
   ``plan_schedule`` on their C, corr once a lane; with ``--bootstrap 8
   --dataset NCI-60 --journal``, its stable edges ``bootstrap_pc``'s and
   every span in the journal with its duration; (b) ``pc_serve``'s stream
   through ``PCService`` on a MonotonicClock at the batch cell's shape
   (64 requests alternating n = 96 and 48, m = 3000, density 0.015,
   α = 0.01, one α sweep, cap 3, slots of 8, Poisson arrivals at 50/s):
   no rejection or dead letter, every delivered graph bitwise a solo
   ``pc_scan`` on its C at its α, corr once a request; requests/s, latency
   p50/p99, the queue-wait/dispatch/assembly breakdown, the programs
   recorded and evicted, peak memory; then the §5.6 instance as one
   request (its first call predicted from phase 3's degrees and phase 6
   (b)'s seconds a recorded step; cap 2, cap 1 where that prediction is
   over a minute), bitwise the host loop's "S-kernel"; (c) the same
   stream under ``pc_serve --faults`` (ManualClock): req-2 rejected,
   req-4 delivered wider, req-6 retried for corruption, req-8
   dead-lettered, the event sequence equal to the port's CPU run of the
   stream on the card's C; a degrade run to the stable-ref rung, its
   skeleton explained against the solo scan; (d) a GET of ``pc_serve``'s
   /metrics endpoint on a free localhost port;
8. mesh (``repro_torch.core.distributed``, ``core/sharding.py``): a mesh
   of 4 logical shards on the card (every visible card when there are
   more). ``pc_distributed`` on NCI-60 and the §5.6 instance under "S"
   and "S-grid" in the layouts replicated, ``shard_c``, ``shard_sep`` and
   ``shard_c`` + ``shard_sep`` (with ``speculate`` under "S-grid"), and
   "S" at pipeline depth 2, each with the counts reset just before and
   read just after (corr, level0 once; "S-grid": sgrid once a shard a
   planned launch): adj, sepsets and CPDAG bitwise the single-device
   ``pc(x, engine=e)``, the per-level chunks, dispatches and column-gather
   bytes, a steady call's seconds (and, on NCI-60, single-device "S" at
   a 16× smaller cell budget bitwise the default: a test decides the
   same in a chunk of any shape). ``ops.chunk_s_grid_tests_cols`` (the
   sharded-C route: ``gather_s_cols`` and sgrid's gathered entry) on every
   shard's first launch of NCI-60's ℓ = 1 and §5.6's ℓ = 2: winners
   within the τ band of the plain version and bitwise the fused entry's,
   timed beside the fused route, its bound as phase 2's gathered rows
   count it. ``pc_scan_batch`` on the batch cell (a) and ``bootstrap_pc``
   (18 replicates of (a)'s lane 0: an identity-lane pad) with ``mesh=``,
   bitwise their ``mesh=None`` runs; (b)'s stream through
   ``PCService(ServeConfig(mesh=))``, every graph bitwise the unsharded
   service's. The phase prints its seconds;
9. contracts (``repro_torch.analysis``, ``python -m repro_torch.analysis``):
   layers 1–3 of the port's contract suite on the card, gated on
   ``analysis_baseline_torch.json`` (no finding outside it, no stale
   entry): the AST rules over ``src/repro_torch``; every entry point's
   hand-kernel count against the declared table, its float64 ops and its
   ``torch.cuda.set_sync_debug_mode("warn")`` warnings (none outside the
   allowlisted seams), the engines' live-run stats and the recorded
   ``pc_scan`` program's graph census; each kernel entry under a poisoned
   allocator (0xFF, 0x00), twice on the same inputs, against its plain
   version, and every entry function's ptxas registers, stack, spills and
   shared memory beside the card's name and power limit. The phase
   prints its seconds;
10. LM serving (``repro_torch.launch.serve``, ``repro_torch.models``):
   (a) ``serve.main(["--arch", "qwen3-1.7b"])`` twice, the full width
   (28 layers, d_model 2048, vocab 151 936 padded to 152 064; batch 4,
   prompt 32, 16 generated tokens, bf16 compute, fp32 parameters), its
   prefill ms, decode tokens/s and peak memory, then a steady prefill and
   decode step traced; (b) the same model in fp32 compute: finite logits,
   and a decode step after a prefill of T within the reference's 2e-2 of
   the prefill of T + 1; (c) the full width cut to 2 layers, the card
   against the port's CPU run on the same parameters and prompts (fp32
   compute), a prefill and 4 greedy decode steps: logits within 1e-3 ·
   max |logit| (fp32 cache) or 2e-2 (bf16 cache), greedy tokens equal;
   (d) the same for the other four attention-MLP archs, reduced. Every
   other decoder segment kind: (e) ``--arch qwen2-moe-a2.7b`` (MoE: 24
   layers, 60 routed + 4 shared experts padded to 64, top-4; 56.4 GiB of
   fp32 parameters) as (a), with its prefill's capacity drops counted, and
   as (b) at full depth with MoE capacity factor 8; (f) ``--arch
   rwkv6-3b`` and ``--arch zamba2-1.2b`` once each, and each as (b)
   (rwkv6-3b also at 8 of its 32 layers, ``RWKV_HELD_DEPTH``);
   (g) deepseek-v2-236b at full width cut to 3 layers (1 MLA + dense, 2
   MLA + MoE) through ``registry.build`` as (b), its compressed cache on
   the card. (b), (e)-(g) run the check through an fp32 and a bf16 cache,
   each held to the reference's 2e-2, or to 4 times the model's response
   to a 1e-7 relative change of its embeddings where that is larger (a
   chaotic model: rwkv6-3b at 32 layers); the bf16 cache's, or to twice
   what its stored values' rounding alone moves the fp32 decode step
   where that is larger; an MoE model is held on the rows whose selections did not flip,
   and on every row with its routing pinned to the prefill's (ROADMAP
   Queue 3). (h) as (c) on qwen2-moe and rwkv6-3b cut to 2 layers,
   zamba2-1.2b at full depth and deepseek reduced, the MoE selections
   equal token by token; (i) ``mamba2_forward`` against
   ``mamba2_recurrent_ref`` and ``rwkv6_mix_chunked`` against
   ``rwkv6_mix_recurrent`` at full width, T padded to whole chunks, within
   1e-4 · max(1, max |value|); (j) a full-width MoE layer twice, bitwise
   equal. The path has no hand kernel: the launch
   counts, reset just before, stay 0. The phase prints its seconds;
11. Whisper and single-card training (``repro_torch.models.whisper``,
   ``registry.make_train_step``, ``optim``, ``checkpoint``,
   ``distributed.supervisor``, ``launch.train``): (a) whisper-large-v3
   uncut (32 + 32 layers, d_model 1280, 20 heads, enc_ctx 1500, vocab
   51 866 padded to 51 968; seed-0 weights, frames (4, 1500, 1280) · 0.1)
   served through ``registry.build`` (batch 4, 32-token prompts, 16 greedy
   tokens, bf16 compute, fp32 parameters, a bf16 cache) twice: prefill ms,
   the encoder alone, tokens/s, peak memory, a steady decode step traced;
   (b) the same in fp32 compute, a decode step after a prefill of T
   against the prefill of T + 1 through an fp32 and a bf16 cache, held by
   phase 10's rule; (c) the full width cut to 2 + 2 layers, the card
   against the port's CPU run: a prefill and 4 decode steps, logits within
   1e-3 · max |logit| (fp32 cache), tokens equal; (d) qwen3-1.7b uncut,
   ``TrainConfig`` defaults (bf16 compute, fp32 parameters, remat, clip
   1.0, weight decay 0.1) with ``launch.train``'s schedule for 8 steps
   (lr 1e-3, warmup 5), 8 steps of ``make_train_step`` on
   ``TokenPipeline`` batches of 8 × 128: every loss and gradient norm
   finite, the last loss below the first and step 0's batch again below
   its step-0 loss, the median steady step,
   tokens/s, peak memory and one step traced; (e) one train step, fp32,
   card against CPU on qwen3-1.7b at full width cut to 2 layers and
   whisper at full width cut to 2 + 2 layers with enc_ctx cut to 256,
   batch 2 × 64: the loss, every gradient leaf and every parameter after
   the AdamW step to tolerances stated before the run (``TRAIN_TOL``), and
   the card's step again from the same state bitwise equal; (f)
   ``python -m repro_torch.launch.train --arch qwen3-1.7b --reduced
   --steps 12 --ckpt-every 4 --inject-failure 6`` in a subprocess: 1
   restart and a loss history bitwise the uninterrupted run's, and one
   bf16 train step twice from one state bitwise equal on reduced qwen3,
   qwen2-moe and whisper; (g) the flash backward at whisper's encoder
   shape (T = 1500, "none") and qwen3's training shape (T = 128, causal,
   GQA) against autograd through ``sdpa_ref`` in fp32. No hand kernel:
   the launch counts stay 0. The phase prints its seconds.

``python3 chip_smoke.py --phase 11`` runs phase 11 alone (no build, no
``kernels`` line, no ``ok`` record).

The last two lines are a ``{"kernels": [...]}`` record and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
import warnings
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_OPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
BAND = 1e-4
NCI60 = dict(n=1190, m=47, density=0.02, alpha=0.01, seed=0)
SMALL = dict(n=200, m=47, density=0.02, alpha=0.01, seed=1)
# the paper's §5.6 grid instance (src/repro/configs/cupc_datasets.py:31-33)
S56 = dict(n=1000, m=10000, density=0.1, alpha=0.01, seed=0)
# the NCI-60 runs of the other Gaussian engines, compared with "auto"
ENGINE_RUNS = (("S", dict(engine="S")), ("E", dict(engine="E")),
               ("S-grid", dict(engine="S-grid")), ("S depth 3", dict(engine="S", pipeline_depth=3)))
# bnlearn's PIGS network: 441 variables, all ternary, 592 arcs
PIGS = dict(n=441, m=5000, density=0.0061, arity=3, alpha=0.01, seed=0)
D_SMALL = dict(n=40, m=2000, density=0.1, arity=3, alpha=0.01, seed=1)
D_ORACLE = dict(n=12, m=600, density=0.3, arity=3, alpha=0.05, seed=4)
# the reference's many-graph workload: benchmarks/pc_batch.py:46-49, "sparse"
BATCH = dict(B=64, n=96, m=3000, density=0.015, alpha=0.01, max_level=3, seed=100)
SWEEP_ALPHAS = (0.001, 0.005, 0.01, 0.05)
BOOT_REPLICATES = 8
# the discrete scan runs its default cap 3 only when the first call at cap
# 3 (recording included), predicted from cap 2's, takes at most this long
DISCRETE_SCAN_S = 60.0
P_BAND = 1e-4
U32 = 2.0**-24
# fp32 operations per tested level-1 cell: num 2, den 5, max 1, rsqrt 1,
# mul 1, clip 2, atanh ≈ 5 (sub, div, log1p, mul), abs+compare 1
L1_OPS_PER_CELL = 18
# per level-0 cell: clip 2, atanh ≈ 5, abs 1, compare 1, i ≠ j and the and 2
LEVEL0_OPS_PER_CELL = 11
# per G² term: 4 logs ≈ 4 × 5, max 4, add/sub 3, mul 1, select and the
# in-order add 2; per sample: bounds check and count 2
G2_OPS_PER_TERM = 30
G2_OPS_PER_SAMPLE = 2


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def cuda_ms(torch, fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, fn, reps=20):
    """Device time per call of ``fn``: ``reps`` calls captured in one CUDA
    graph and replayed, so the host's time between launches drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(torch, graph.replay, reps=5, warmup=1) / reps


def level0_old_span(torch, level0, c, tau, depth):
    """The level-0 span before it was fused: the adjacency kernel and six
    PyTorch ops (the sepset fill, a where, a cast, the slot-0 write, the
    row sums and their max), without the driver's read of the max."""
    adj = level0.level0_kernel(c, tau)
    n = c.shape[0]
    sep = torch.full((n, n, depth), -1, dtype=torch.int32, device=c.device)
    sep[:, :, 0] = torch.where(adj, -1, -2).to(torch.int32)
    return adj, sep, adj.sum(dim=1, dtype=torch.int32).max()


def level0_phase(torch, label, c, tau, depth=8):
    """Both level0 entries exactly equal to their plain versions on C, and
    the old seven-op span equal to the fused one; the adjacency entry, the
    fused entry, the old span and the plain span timed with ``cuda_ms``
    and ``graph_ms``, beside the bounds 5·n² and (5 + 4·depth)·n² bytes.
    Returns the kernel record's row: the fused entry, graph times."""
    from repro_torch.core import levels as L
    from repro_torch.kernels import level0

    n = c.shape[0]
    adj_p = L.level0(c, tau)
    n_diff = int((level0.level0_kernel(c, tau) != adj_p).sum())
    got = level0.level0_span(c, tau, depth)
    want = L.level0_span(c, tau, depth)
    old = level0_old_span(torch, level0, c, tau, depth)
    err = max(float((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0.0
              for a, b in zip(got, want))
    same = all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, want))
    same_old = all(torch.equal(a, b) for a, b in zip(old, want))
    fns = (("adjacency", lambda: level0.level0_kernel(c, tau)),
           ("fused", lambda: level0.level0_span(c, tau, depth)),
           ("old span", lambda: level0_old_span(torch, level0, c, tau, depth)),
           ("plain span", lambda: L.level0_span(c, tau, depth)))
    times = {name: (cuda_ms(torch, fn), graph_ms(torch, fn)) for name, fn in fns}
    b_adj, by_adj = bound(5 * n * n, LEVEL0_OPS_PER_CELL * n * n)
    b_span, by_span = bound((5 + 4 * depth) * n * n, LEVEL0_OPS_PER_CELL * n * n)
    print(f"kernel level0 {label} n={n}: {int(adj_p.sum()) // 2} edges, max degree "
          f"{int(want[2])}; adjacency entry differs from levels.level0 in {n_diff} cells, "
          f"fused entry (depth {depth}) max_abs_err {err:g} against levels.level0_span "
          f"(exact required; the old seven-op span equal: {same_old}); ms (events, graph): "
          + ", ".join(f"{k} {a:.5f} {g:.5f}" for k, (a, g) in times.items())
          + f"; bound adjacency {b_adj:.5f} ({by_adj}, 5·n² bytes), span {b_span:.5f} "
          f"({by_span}, {5 + 4 * depth}·n² bytes)")
    check(n_diff == 0, f"level0 {label} differs from its plain version in {n_diff} cells")
    check(same and err == 0.0, f"level0_span {label} differs from levels.level0_span")
    check(same_old, f"level0_span {label} differs from the seven-op span")
    return dict(max_abs_err=err, ms=times["fused"][1], plain_ms=times["plain span"][1],
                bound_ms=b_span, bound_by=by_span, library_ms=None)


def bound(bytes_moved, ops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cholinv_ops(ell):
    """fp32 operations of one set in csrc/cholinv.cu, counted from its loops."""
    ops = (ell - 1) + 2 + ell  # scale, jit_eff, diagonal jitter
    for j in range(ell):
        ops += 2 * j + 3  # diagonal: j mul-sub pairs, max, sqrt, reciprocal
        ops += (ell - j - 1) * (2 * j + 1)  # below-diagonal entries
    for j in range(ell):
        ops += 1
        for i in range(j + 1, ell):
            ops += 1 + 2 * (i - j - 1) + 1
    for i in range(ell):
        for j in range(i, ell):
            ops += 2 * (ell - j) + 2 + (2 if i != j else 0)
    return ops + 2 * ell  # var


def cisweep_ops(ell):
    return 5 * ell + 4 * (ell * (ell - 1) // 2) + 12


def band_diff(got, want, lo, hi):
    """(# differing cells, # differing cells whose decision does not move
    between τ − 1e-4 and τ + 1e-4)."""
    diff = got != want
    outside = diff & (lo == hi)
    return int(diff.sum()), int(outside.sum())


def gather_tests(c64, i, j, sets):
    """What CI test (i, j | S) reads of C, for index arrays i, j (k,) and
    sets (k, ℓ): (C_ij, C(i,S), C(j,S), C[S,S])."""
    return (c64[i, j], c64[i[:, None], sets], c64[j[:, None], sets],
            c64[sets[:, :, None], sets[:, None, :]])


def z_of(cij, ci, cj, m2):
    """(|atanh ρ(i, j | S)| in float64, and a first-order bound on how far
    the fp32 evaluation of the same test can stray from it).

    The bound: a Cholesky-based solve in fp32 is backward stable with
    error about (ℓ + 1)·u·‖M2⁻¹‖ (u = 2^-24), so the residual variances
    var = 1 − cᵀM2⁻¹c and the numerator C_ij − C(i,S)ᵀM2⁻¹C(j,S) carry
    absolute errors up to e = 2(ℓ + 1)·u·(1 + ‖M2⁻¹‖·‖c‖²); these move ρ
    by e_num/√(var_i·var_j) + |ρ|·(e_i/2var_i + e_j/2var_j) and z by that
    over 1 − ρ². Tests on nearly collinear variables (|C| → 1) have small
    residual variances and a large bound: fp32 cannot decide them. A test
    whose C[S,S] is singular (variables of S perfectly correlated in the
    fp32 C) has no partial correlation at all: z and its bound are +inf."""
    import numpy as np

    ell = ci.shape[1]
    singular = np.zeros(cij.shape, dtype=bool)
    if ell == 0:
        rho, drho = cij, np.zeros_like(cij)
    else:
        lam = np.linalg.eigvalsh(m2)[:, 0]
        singular = lam <= 1e-12
        m2 = np.where(singular[:, None, None], np.eye(ell), m2)
        gi = np.linalg.solve(m2, ci[..., None])[..., 0]
        gj = np.linalg.solve(m2, cj[..., None])[..., 0]
        num = cij - np.einsum("ka,ka->k", ci, gj)
        vi = 1.0 - np.einsum("ka,ka->k", ci, gi)
        vj = 1.0 - np.einsum("ka,ka->k", cj, gj)
        den = np.sqrt(np.maximum(vi * vj, 1e-300))
        rho = num / den
        inv_norm = 1.0 / np.maximum(lam, 1e-300)
        k = 2 * (ell + 1) * 2.0**-24
        ni, nj = (ci * ci).sum(1), (cj * cj).sum(1)
        e_i, e_j = k * (1 + inv_norm * ni), k * (1 + inv_norm * nj)
        e_num = k * (np.abs(cij) + inv_norm * np.sqrt(ni * nj))
        with np.errstate(divide="ignore", invalid="ignore"):
            drho = e_num / den + np.abs(rho) * (e_i / (2 * vi) + e_j / (2 * vj))
        drho = np.where((vi > e_i) & (vj > e_j), drho, np.inf)
    rho = np.clip(rho, -0.9999999, 0.9999999)
    z, err = np.abs(np.arctanh(rho)), drho / (1 - rho * rho)
    return np.where(singular, np.inf, z), np.where(singular, np.inf, err)


def certify(run, c64, m, alpha, threshold):
    """Every recorded sepset must pass its CI test recomputed in float64:
    z ≤ τ, or within the band τ + 1e-4, or (ill-conditioned for fp32)
    within τ + 1e-4 + its fp32 error bound. Returns per-ℓ counts; raises
    on a failure."""
    import numpy as np

    n = run.adj.shape[0]
    iu, ju = np.triu_indices(n, 1)
    srows = run.sepsets[iu, ju]
    keep = ~run.adj[iu, ju] & (srows[:, 0] >= 0)
    iu, ju, srows = iu[keep], ju[keep], srows[keep]
    sizes = (srows >= 0).sum(axis=1)
    counts = {}
    for ell in np.unique(sizes):
        sel = sizes == ell
        tau = threshold(m, int(ell), alpha)
        z, err = z_of(*gather_tests(c64, iu[sel], ju[sel], srows[sel, :ell].astype(np.int64)))
        bad = z > tau + BAND + err
        if bad.any():
            raise PhaseError(f"sepset certificate failed at ℓ={ell}: {int(bad.sum())} sets "
                             f"with z > τ + {BAND} + fp32 error bound (worst z - τ = "
                             f"{float((z - tau)[bad].max()):.3g})")
        singular = np.isinf(z)
        if singular.any():
            k = int(np.flatnonzero(singular)[0])
            ids = srows[sel][k, :ell].astype(np.int64)
            block = c64[np.ix_(ids, ids)]
            print(f"  note: {int(singular.sum())} ℓ={ell} sepsets have a singular C[S,S], e.g. "
                  f"({iu[sel][k]}, {ju[sel][k]} | {ids.tolist()}) with max |C| off its "
                  f"diagonal {float(np.abs(block - np.diag(np.diag(block))).max())!r}")
        counts[int(ell)] = dict(checked=int(sel.sum()),
                                band=int(((z > tau) & (z <= tau + BAND)).sum()),
                                fp32_undecidable=int((z > tau + BAND).sum()),
                                singular=int(singular.sum()))
    return counts


def explain_diffs(a, b, c64, m, alpha, threshold, sepsets=True, empty=False):
    """Edges where two runs differ in adjacency or (with ``sepsets``) in
    sepset; each must be explained by a CI test of either run's sepset
    lying within the band (plus its fp32 error bound) of τ. ``empty``
    also explains a level-0 removal (the -2 sentinel) by its test."""
    import numpy as np

    n = a.adj.shape[0]
    iu, ju = np.triu_indices(n, 1)
    differ = a.adj[iu, ju] != b.adj[iu, ju]
    if sepsets:
        differ |= (a.sepsets[iu, ju] != b.sepsets[iu, ju]).any(1)
    unexplained = 0
    for i, j in zip(iu[differ], ju[differ]):
        near = False
        for run in (a, b):
            s = run.sepsets[i, j]
            if run.adj[i, j] or (s[0] < 0 and not (empty and s[0] == -2)):
                continue
            ids = s[s >= 0].astype(np.int64)
            z, err = z_of(*gather_tests(c64, np.array([i]), np.array([j]), ids[None, :]))
            near |= abs(z[0] - threshold(m, len(ids), alpha)) <= BAND + err[0]
        unexplained += not near
    return int(differ.sum()), unexplained


def discrete_codes(sample_discrete_dag, cfg):
    """Seeded categorical samples for ``cfg``; a column the generator left
    constant gets one flipped code, as the repository's test fixtures do
    (validation refuses one-level columns)."""
    x, dag = sample_discrete_dag(cfg["n"], cfg["m"], cfg["density"], cfg["arity"],
                                 seed=cfg["seed"])
    for k in range(cfg["n"]):
        if (x[:, k] == x[0, k]).all():
            x[0, k] = (x[1, k] + 1) % cfg["arity"]
    return x, dag


def g2_of(codes, arities, r, i, j, s):
    """(p of the G² test (i, j | S) in float64, and a first-order bound on
    how far the port's fp32 p can stray from it).

    The fp32 G² sums K = r^(ℓ+2) terms N·(((log N + log N_c) − log N_a) −
    log N_b): each log is within an ulp, each add and the product round
    once, and the in-order sum of K terms adds at most K·u·Σ|term|, so
    e_G² ≤ 2·(4u·Σ N·(|log N| + |log N_c| + |log N_a| + |log N_b|) +
    (K + 1)·u·Σ|term|), and p moves by at most chi2.pdf(G², dof)·e_G².
    Tables with large, nearly cancelling terms have a large bound."""
    import numpy as np
    from scipy.stats import chi2

    ri, rj = int(arities[i]), int(arities[j])
    q = 1
    code = np.zeros(codes.shape[0], dtype=np.int64)
    for k in s:
        code = code * int(arities[k]) + codes[:, k]
        q *= int(arities[k])
    code = (code * ri + codes[:, i]) * rj + codes[:, j]
    tab = np.bincount(code, minlength=q * ri * rj).astype(np.float64).reshape(q, ri, rj)
    logs = [np.log(np.maximum(v, 1.0)) for v in
            (tab, tab.sum(axis=(1, 2), keepdims=True), tab.sum(axis=2, keepdims=True),
             tab.sum(axis=1, keepdims=True))]
    term = np.where(tab > 0, tab * (logs[0] + logs[1] - logs[2] - logs[3]), 0.0)
    g2 = 2.0 * float(term.sum())
    dof = max((ri - 1) * (rj - 1) * q, 1)
    k_total = r ** (len(s) + 2)
    e_g2 = 2.0 * (4 * U32 * float((tab * sum(np.abs(v) for v in logs)).sum())
                  + (k_total + 1) * U32 * float(np.abs(term).sum()))
    return float(chi2.sf(g2, dof)), float(chi2.pdf(g2, dof)) * e_g2


def certify_g2(run, codes, r, alpha):
    """Every sepset recorded at ℓ ≥ 1 must pass its G² test in float64:
    p ≥ α, or p in the band |p/α − 1| ≤ 1e-4, or (fp32 cannot decide it)
    within the band plus its fp32 error bound. Returns per-ℓ counts; raises
    on a failure."""
    arities = codes.max(axis=0) + 1
    counts = {}
    for (i, j), ids in run.sepset_dict().items():
        if not ids:
            continue
        p, dp = g2_of(codes, arities, r, i, j, ids)
        cnt = counts.setdefault(len(ids), dict(checked=0, band=0, fp32_undecidable=0))
        cnt["checked"] += 1
        if p >= alpha:
            continue
        if p >= alpha * (1 - P_BAND):
            cnt["band"] += 1
        elif p >= alpha * (1 - P_BAND) - dp:
            cnt["fp32_undecidable"] += 1
        else:
            raise PhaseError(f"G² certificate failed: ({i}, {j} | {ids}) has float64 p = {p:.6g} "
                             f"< α = {alpha} beyond the band and its fp32 bound {dp:.3g}")
    return dict(sorted(counts.items()))


def explain_g2_diffs(a, b, codes, r, alpha):
    """Edges where two discrete runs differ in adjacency or sepset; each
    must be explained by a test of either run's sepset (the empty set for
    a level-0 removal) whose float64 p lies within the p band (plus its
    fp32 bound) of α."""
    import numpy as np

    arities = codes.max(axis=0) + 1
    n = a.adj.shape[0]
    iu, ju = np.triu_indices(n, 1)
    differ = (a.adj[iu, ju] != b.adj[iu, ju]) | (a.sepsets[iu, ju] != b.sepsets[iu, ju]).any(1)
    unexplained = 0
    for i, j in zip(iu[differ], ju[differ]):
        near = False
        for run in (a, b):
            if run.adj[i, j]:
                continue
            s = run.sepsets[i, j]
            p, dp = g2_of(codes, arities, r, i, j, tuple(int(v) for v in s[s >= 0]))
            near |= abs(p - alpha) <= alpha * P_BAND + dp
        unexplained += not near
    return int(differ.sum()), unexplained


def sgrid_work(torch, t_p, mask, n_valid=None):
    """What a launch's data needs of an sgrid sweep: each (row, slot) tests
    its masked-in ranks up to its winner, each row inverts the sets up to
    its last winner (or its last valid rank, ``n_valid`` (n_l,) when
    given). Returns (visited cells, tested cells, set inverses, separated
    slots)."""
    n_l, t_len, npr = mask.shape
    found = t_p < 2**30
    last = t_len - 1 if n_valid is None else (n_valid.to(t_p.dtype) - 1)[:, None]
    limit = torch.where(found, t_p, last)
    local = torch.arange(t_len, device=mask.device)
    visited = local[None, :, None] <= limit[:, None, :]
    cells = int(visited.sum())
    tested = int((visited & mask.to(torch.bool)).sum())
    ranks = int((limit.max(dim=1).values + 1).sum()) if npr else 0
    return cells, tested, ranks, int(found.sum())


def fused_need(torch, c, compact, rows, s_ids, mask, t_p, cj_copy):
    """What one fused launch's data needs: the cells up to each slot's
    winner (its last rank where none) that the mask lets in, the sets
    those cells use, and the bytes they read, each input element once —
    the distinct entries of C (C[S,S] and C(i,S) of the needed sets, C_ij
    of the slots that test, C[j,S] of the cells; ``cj_copy``: C[j,S] read
    from a transposed copy, a second array), adj at the listed slots, the
    lists, counts and row ids — and the outputs written once. The binomial
    table's few entries are left out. Returns (bytes, sets, tested cells)."""
    n = c.shape[0]
    n_l, t_len, npr = mask.shape
    ell = s_ids.shape[-1]
    local = torch.arange(t_len, device=mask.device)
    limit = torch.where(t_p < 2**30, t_p, t_len - 1)
    need = mask.to(torch.bool) & (local[None, :, None] <= limit[:, None, :])
    staged = need.any(2)
    s, i = s_ids.long(), rows.long()
    j = compact.clamp(0, n - 1).long()
    ss, si = s[staged], i[:, None].expand(n_l, t_len)[staged]
    r_c, t_c, p_c = need.nonzero(as_tuple=True)
    from_c = torch.cat([(ss[:, :, None] * n + ss[:, None, :]).reshape(-1),
                        (si[:, None] * n + ss).reshape(-1),
                        (i[:, None] * n + j)[need.any(1)]])
    from_cj = (j[r_c, p_c][:, None] * n + s[r_c, t_c]).reshape(-1)
    if cj_copy:
        entries = from_c.unique().numel() + from_cj.unique().numel()
    else:
        entries = torch.cat([from_c, from_cj]).unique().numel()
    bytes_moved = (4 * entries + int((compact >= 0).sum()) + 4 * compact.numel() + 8 * n_l
                   + 4 * n_l * npr * (ell + 1))
    return bytes_moved, int(staged.sum()), int(need.sum())


def winners_check(torch, label, got, plain):
    """Winners of an sgrid or skernel entry against its plain version ``plain(d)`` at
    τ + d: equal in every (row, slot) whose winner does not move between
    τ − 1e-4 and τ + 1e-4. Returns (plain winners, # differing, # outside
    the band, # band cells, max |t_k − t_p| outside)."""
    t_k, s_k = got
    (t_p, s_p), (t_lo, _), (t_hi, _) = plain(0.0), plain(-BAND), plain(BAND)
    diff = (t_k != t_p) | (s_k != s_p).any(-1)
    outside = diff & (t_lo == t_hi)
    err = float(torch.where(outside, (t_k - t_p).abs(), 0).max()) if t_k.numel() else 0.0
    check(not bool(outside.any()), f"{label}: winners differ outside the τ band")
    return t_p, int(diff.sum()), int(outside.sum()), int((t_lo != t_hi).sum()), err


def sgrid_phase(torch, label, args, tau):
    """The gathered sgrid entry against its plain version on one gathered
    launch; timed; its bound counted from what this launch's data needs
    (``sgrid_work``) over the gathered operands it reads."""
    from repro_torch.kernels import sgrid

    m2, ci_s, cj_s, cij, mask, s_ids = args
    n_l, t_len, npr = mask.shape
    ell = m2.shape[-1]
    t_p, n_diff, n_out, n_band, err = winners_check(
        torch, f"sgrid {label}", sgrid.sgrid(*args, tau),
        lambda d: sgrid.sgrid_plain(*args, tau + d))
    k_ms = cuda_ms(torch, lambda: sgrid.sgrid(*args, tau))
    p_ms = cuda_ms(torch, lambda: sgrid.sgrid_plain(*args, tau), reps=3, warmup=1)
    cells, tested, ranks, found = sgrid_work(torch, t_p, mask)
    bytes_moved = (ranks * (ell * ell + ell) * 4 + cells + tested * 4 * ell + n_l * npr * 4
                   + found * ell * 4 + n_l * npr * (ell + 1) * 4)
    b_ms, b_by = bound(bytes_moved, ranks * cholinv_ops(ell) + tested * cisweep_ops(ell))
    print(f"kernel sgrid (gathered) {label}: n_l={n_l} T={t_len} n′={npr} ℓ={ell}: {found} of "
          f"{n_l * npr} slots separated; winners differ in {n_diff} cells ({n_out} outside the "
          f"τ band, {n_band} band cells); kernel {k_ms:.4f} ms plain {p_ms:.4f} ms bound "
          f"{b_ms:.5f} ms ({b_by}: {tested} tested of {cells} visited cells, {ranks} set "
          "inverses)")
    return dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def sgrid_fused_phase(torch, label, c, adj, ell, budget, tau):
    """The first launch of a level as "S-grid" plans it, through the fused
    entry (C, Cᵀ, adj, neighbour lists and counts, the first rank; no
    unrank or gather on the host) against its plain version (``plan_sets``,
    ``gather_sets``, ``sgrid_plain``); timed beside ``levels.gather_s``
    alone (unrank and gather) and the gathered entry on the same launch.
    Bound: what this launch's data needs (``fused_need``: the entries of
    C, Cᵀ, adj and the lists the tests read, the outputs; the sets and
    cells up to each winner)."""
    from repro_torch.core import levels as L
    from repro_torch.core.compact import compact_rows
    from repro_torch.kernels import sgrid

    n = c.shape[0]
    npr = int(adj.sum(1).max())
    npr_b, n_chunk, total = L.plan_level(npr, ell, n, cell_budget=budget, n_cols=n)
    compact, counts = compact_rows(adj, n_prime=npr_b)
    ranks = torch.arange(n_chunk, dtype=torch.int32, device=c.device)
    rows = torch.arange(n, dtype=torch.int32, device=c.device)
    print(f"ℓ={ell} S-grid launch: max degree {npr} (bucket {npr_b}), {total} ranks, "
          f"{n_chunk} a launch, {-(-total // n_chunk)} launches")
    c_t = c.T.contiguous()
    t0 = torch.zeros((), dtype=torch.int32, device=c.device)
    fused = (c, adj, compact, counts, rows, t0)
    kw = dict(ell=ell, n_chunk=n_chunk, n_max=npr_b)
    s_ids, valid = L.plan_sets(compact, counts, ranks, ell=ell, n_max=npr_b, n=n)
    gathered = L.gather_sets(c, adj, compact, rows, s_ids, valid)

    def plain(d):
        return sgrid.sgrid_plain(*gathered, s_ids, tau + d)

    def plain_path():
        s, v = L.plan_sets(compact, counts, ranks, ell=ell, n_max=npr_b, n=n)
        return sgrid.sgrid_plain(*L.gather_sets(c, adj, compact, rows, s, v), s, tau)

    t_p, n_diff, n_out, n_band, err = winners_check(
        torch, f"sgrid {label}", sgrid.sgrid_fused(*fused, tau, c_t=c_t, **kw), plain)
    k_ms = cuda_ms(torch, lambda: sgrid.sgrid_fused(*fused, tau, c_t=c_t, **kw))
    p_ms = cuda_ms(torch, plain_path, reps=3, warmup=1)
    g_ms = cuda_ms(torch, lambda: L.gather_s(c, adj, compact, counts, rows, ranks, ell=ell,
                                             n_max=npr_b))
    plan_ms = cuda_ms(torch, lambda: L.plan_sets(compact, counts, ranks, ell=ell, n_max=npr_b,
                                                 n=n))
    gk_ms = cuda_ms(torch, lambda: sgrid.sgrid(*gathered, s_ids, tau))
    t_ms = cuda_ms(torch, lambda: c.T.contiguous())
    cells, _, _, found = sgrid_work(torch, t_p, gathered[-1], valid.sum(1))
    bytes_moved, inverses, tested = fused_need(torch, c, compact, rows, s_ids, gathered[-1], t_p,
                                               cj_copy=True)
    b_ms, b_by = bound(bytes_moved, inverses * cholinv_ops(ell) + tested * cisweep_ops(ell))
    print(f"kernel sgrid (fused) {label}: n_l={n} T={n_chunk} n′={npr_b} ℓ={ell}: {found} of "
          f"{n * npr_b} slots separated; winners differ in {n_diff} cells ({n_out} outside "
          f"the τ band, {n_band} band cells); kernel {k_ms:.4f} ms plain {p_ms:.4f} ms bound "
          f"{b_ms:.5f} ms ({b_by}: {bytes_moved} bytes, {tested} tested of {cells} visited "
          f"cells, {inverses} set inverses); on the same launch: levels.gather_s {g_ms:.4f} ms "
          f"(plan_sets alone {plan_ms:.4f}), the gathered entry {gk_ms:.4f} ms, Cᵀ copy "
          f"{t_ms:.4f} ms")
    return dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def skernel_phase(torch, label, c, adj, tau):
    """The first ℓ = 2 chunk of a level as "auto" plans it (``plan_level``
    at the default budget) through the fused S-kernel: its winners bitwise
    those of cholinv + cisweep on ``gather_s``'s output and ``_winners``
    (``skernel_two_launch``, on the same card), and within the τ band of
    its plain version (``plan_sets``, ``gather_sets``, the plain cholinv
    and cisweep, ``_winners``); timed beside ``levels.gather_s``,
    ``plan_sets`` alone, cholinv, cisweep and the whole two-launch chunk.
    Bound: what this chunk's data needs (``fused_need``: the entries of C,
    adj and the lists the tests read, the outputs; the sets and cells up
    to each winner)."""
    from repro_torch.core import levels as L
    from repro_torch.core.compact import compact_rows
    from repro_torch.kernels import cholinv, cisweep, skernel

    ell = 2
    n = c.shape[0]
    npr = int(adj.sum(1).max())
    npr_b, n_chunk, total = L.plan_level(npr, ell, n, n_cols=n)
    compact, counts = compact_rows(adj, n_prime=npr_b)
    rows = torch.arange(n, dtype=torch.int32, device=c.device)
    ranks = torch.arange(n_chunk, dtype=torch.int32, device=c.device)
    args = (c, adj, compact, counts, rows, torch.zeros((), dtype=torch.int32, device=c.device))
    kw = dict(ell=ell, n_chunk=n_chunk, n_max=npr_b)
    got = skernel.skernel_fused(*args, tau, **kw)
    two = skernel.skernel_two_launch(*args, tau, **kw)
    bitwise = torch.equal(got[0], two[0]) and torch.equal(got[1], two[1])
    t_p, n_diff, n_out, n_band, err = winners_check(
        torch, f"skernel {label}", got, lambda d: skernel.skernel_plain(*args, tau + d, **kw))
    check(bitwise, f"skernel {label}: winners are not bitwise those of cholinv + cisweep")
    s_ids, valid = L.plan_sets(compact, counts, ranks, ell=ell, n_max=npr_b, n=n)
    m2, ci_s, cj_s, cij, mask = L.gather_sets(c, adj, compact, rows, s_ids, valid)
    b = n * n_chunk
    m2, ci_s = m2.reshape(b, ell, ell).contiguous(), ci_s.reshape(b, ell).contiguous()
    cj_s, cij = cj_s.reshape(b, npr_b, ell).contiguous(), cij.reshape(b, npr_b).contiguous()
    mask_b = mask.reshape(b, npr_b).contiguous()
    g, u, var = cholinv.cholinv(m2, ci_s)
    k_ms = cuda_ms(torch, lambda: skernel.skernel_fused(*args, tau, **kw))
    p_ms = cuda_ms(torch, lambda: skernel.skernel_plain(*args, tau, **kw), reps=3, warmup=1)
    two_ms = cuda_ms(torch, lambda: skernel.skernel_two_launch(*args, tau, **kw), reps=5)
    g_ms = cuda_ms(torch, lambda: L.gather_s(c, adj, compact, counts, rows, ranks, ell=ell,
                                             n_max=npr_b), reps=5)
    plan_ms = cuda_ms(torch, lambda: L.plan_sets(compact, counts, ranks, ell=ell, n_max=npr_b,
                                                 n=n), reps=5)
    ci_ms = cuda_ms(torch, lambda: cholinv.cholinv(m2, ci_s))
    sw_ms = cuda_ms(torch, lambda: cisweep.cisweep(g, u, var, cj_s, cij, mask_b, tau))
    cells, _, _, found = sgrid_work(torch, t_p, mask, valid.sum(1))
    bytes_moved, inverses, tested = fused_need(torch, c, compact, rows, s_ids, mask, t_p,
                                               cj_copy=False)
    b_ms, b_by = bound(bytes_moved, inverses * cholinv_ops(ell) + tested * cisweep_ops(ell))
    print(f"kernel skernel {label}: n_l={n} T={n_chunk} n′={npr_b} ℓ={ell} ({total} ranks, "
          f"{-(-total // n_chunk)} chunks): {found} of {n * npr_b} slots separated; bitwise equal "
          f"to cholinv + cisweep on gather_s {bitwise}; against the plain version winners differ "
          f"in {n_diff} cells ({n_out} outside the τ band, {n_band} band cells); kernel "
          f"{k_ms:.4f} ms plain {p_ms:.4f} ms bound {b_ms:.5f} ms ({b_by}: {bytes_moved} bytes, "
          f"{tested} tested of {cells} visited cells, {inverses} set inverses, "
          f"{int(valid.sum())} valid sets of {b}, {int(mask.sum())} masked-in of {b * npr_b} "
          f"cells); on the same chunk: the two-launch path {two_ms:.4f} ms, levels.gather_s "
          f"{g_ms:.4f} ms (plan_sets alone {plan_ms:.4f}), cholinv {ci_ms:.4f} ms, cisweep "
          f"{sw_ms:.4f} ms")
    return dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def synthetic_launch(torch, n_l, t_len, npr, ell, seed, dev):
    """A seeded random launch with SPD m2, made on ``dev``."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def normal(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    a = normal(n_l, t_len, ell, ell)
    m2 = a @ a.transpose(-1, -2) / ell + 0.5 * torch.eye(ell, device=dev)
    return (m2, 0.3 * normal(n_l, t_len, ell), 0.3 * normal(n_l, t_len, npr, ell),
            0.3 * normal(n_l, t_len, npr), torch.rand(n_l, t_len, npr, generator=g, device=dev)
            < 0.7, torch.randint(0, 1000, (n_l, t_len, ell), generator=g, device=dev,
                                 dtype=torch.int32))


def level_lines(run):
    for st in run.level_stats:
        print(f"  level {st['level']}: engine {st['engine']} max degree {st['npr']} "
              f"chunks {st['chunks']} dispatches {st.get('dispatches')} n_chunk "
              f"{st.get('n_chunk')} {run.timings_s.get('level%d' % st['level'], 0.0):.4f} s")


def nci60_engines(torch, x_np, auto, c64, launches, dev):
    """``pc(x, engine=e)`` on NCI-60 for the other Gaussian engines, each
    with the counts reset just before it and read just after, against
    "auto" on the same C and certified in float64."""
    from repro_torch import pc
    from repro_torch.core.cit import threshold
    from repro_torch.kernels import build

    cfg = NCI60
    chunked = ("cholinv", "cisweep", "level1", "skernel")
    for label, kw in ENGINE_RUNS:
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.monotonic()
        run = pc(x_np, alpha=cfg["alpha"], device=dev, **kw)
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        counts = dict(build.LAUNCHES)
        chunks = sum(st["chunks"] for st in run.level_stats)
        print(f"e2e pc(x, {', '.join(f'{k}={v!r}' for k, v in kw.items())}) NCI-60: {secs:.3f} s, "
              f"{run.levels_run} levels, {int(run.adj.sum()) // 2} edges, {chunks} chunks, "
              f"launches {json.dumps(counts)}")
        level_lines(run)
        if kw["engine"] == "S-grid":
            launches["sgrid"] = counts["sgrid"]
            check(counts["sgrid"] == chunks > 0 and not any(counts[k] for k in chunked),
                  f"S-grid launched sgrid {counts['sgrid']} times for {chunks} launches "
                  f"planned, or a chunked kernel: {counts}")
        else:
            check(not any(counts[k] for k in chunked + ("sgrid",)),
                  f"{label} launched a kernel of another engine: {counts}")
        # "E" ranks other sets than the shared-set engines: where several
        # separate an edge it records another one, so only its skeleton is
        # held to "auto"; its sepsets are certified below like every run's
        n_diff, unexplained = explain_diffs(run, auto, c64, cfg["m"], cfg["alpha"], threshold,
                                            sepsets=kw["engine"] != "E")
        print(f"  against auto: {n_diff} edges differ ({unexplained} outside the τ band and "
              "fp32 bound)")
        check(unexplained == 0, f"{label} differs from auto outside the τ band and fp32 bound")
        for ell, cnt in certify(run, c64, cfg["m"], cfg["alpha"], threshold).items():
            print(f"  certificate ℓ={ell}: {cnt['checked']} pass, {cnt['band']} in the τ band, "
                  f"{cnt['fp32_undecidable']} within their fp32 bound ({cnt['singular']} "
                  "with a singular C[S,S])")


def section56(torch, dev):
    """The §5.6 grid instance at full n and m: sgrid at its first ℓ = 2
    launch, then "S-grid" against "auto" with per-level chunks and spans."""
    from repro_torch import pc
    from repro_torch.core import engines, levels as L
    from repro_torch.core.cit import threshold
    from repro_torch.data.synthetic_dag import sample_gaussian_dag
    from repro_torch.kernels import build, ops

    cfg = S56
    n, m, alpha = cfg["n"], cfg["m"], cfg["alpha"]
    x_np, _ = sample_gaussian_dag(n, m, cfg["density"], seed=cfg["seed"])
    c = ops.correlation(torch.tensor(x_np, dtype=torch.float32, device=dev))
    tau = [threshold(m, ell, alpha) for ell in range(3)]
    level0_phase(torch, "§5.6", c, tau[0])
    adj0, sep0, _ = ops.level0_span(c, tau[0], 8)
    adj1, _, _ = engines.run_level(c, adj0, sep0, 1, tau[1])
    print(f"§5.6 instance n={n} m={m} density {cfg['density']}: level 0 keeps "
          f"{int(adj0.sum()) // 2} edges, level 1 {int(adj1.sum()) // 2}")
    sgrid_fused_phase(torch, "§5.6 first ℓ=2 launch", c, adj1, 2, L.GRID_CELL_BUDGET, tau[2])
    skernel_phase(torch, "§5.6 first ℓ=2 chunk", c, adj1, tau[2])

    runs, c64 = {}, c.double().cpu().numpy()
    for label, run_kw in (("auto", {}), ("S-grid", dict(engine="S-grid"))):
        build.reset_launches()
        t0 = time.monotonic()
        run = pc(x_np, alpha=alpha, device=dev, **run_kw)
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        print(f"e2e pc(x{', engine=' + repr(label) if run_kw else ''}) §5.6: {secs:.3f} s, "
              f"{run.levels_run} levels, {int(run.adj.sum()) // 2} edges, launches "
              f"{json.dumps(build.LAUNCHES)}, total span {run.timings_s['total']:.4f} s, "
              f"level0 span {run.timings_s['level0']:.6f} s")
        check(build.LAUNCHES["level0"] == 1, f"§5.6 {label} launched level0 "
              f"{build.LAUNCHES['level0']} times, not once")
        level_lines(run)
        runs[label] = run
        if not run_kw:
            chunks = sum(st["chunks"] for st in run.level_stats if st["level"] >= 2)
            check(build.LAUNCHES["skernel"] == chunks > 0 and not build.LAUNCHES["cholinv"]
                  and not build.LAUNCHES["cisweep"],
                  f"§5.6 auto launched skernel {build.LAUNCHES['skernel']} times for {chunks} "
                  f"chunks at ℓ ≥ 2, or cholinv or cisweep: {build.LAUNCHES}")
        else:
            chunks = sum(st["chunks"] for st in run.level_stats)
            check(build.LAUNCHES["sgrid"] == chunks > 0,
                  f"§5.6 S-grid launched sgrid {build.LAUNCHES['sgrid']} times for {chunks}")
            n_diff, unexplained = explain_diffs(run, runs["auto"], c64, m, alpha, threshold)
            print(f"  against auto: {n_diff} edges differ ({unexplained} outside the τ band "
                  "and fp32 bound)")
            check(unexplained == 0, "§5.6 S-grid differs from auto outside the τ band")
        for ell, cnt in certify(run, c64, m, alpha, threshold).items():
            print(f"  certificate ℓ={ell}: {cnt['checked']} pass, {cnt['band']} in the τ "
                  f"band, {cnt['fp32_undecidable']} within their fp32 bound "
                  f"({cnt['singular']} with a singular C[S,S])")
    return runs["auto"]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: the repro_torch package is missing under {SRC}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    warnings.simplefilter("ignore", UserWarning)  # m < n is NCI-60's regime
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    if sys.argv[1:] == ["--phase", "11"]:
        lm_training(torch, smi.stdout.strip())
        print(smi.stdout.strip())
        return 0

    # ---------------------------------------------------------------- build
    t0 = time.monotonic()
    built = build.library()
    print(f"build: {built.seconds:.1f} s nvcc ({time.monotonic() - t0:.1f} s with load) "
          f"-> {built.path.name}")
    for line in built.ptxas.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  ptxas " + line.strip())

    rows, launches = {}, {}
    auto = gaussian(torch, rows, launches)
    auto56 = section56(torch, torch.device("cuda"))
    discrete(torch, rows, launches)
    card = smi.stdout.strip()
    boot = batch(torch, card)
    svc = serving(torch, card, auto, auto56, boot)
    multi_device(torch, card, svc)
    contracts(torch, card)
    lm_serving(torch, card)
    lm_training(torch, card)

    sources = {"corr": ("src/repro_torch/csrc/corr.cu", "src/repro/kernels/corr.py:38"),
               "level0": ("src/repro_torch/csrc/level0.cu", "src/repro/kernels/level0.py:28"),
               "level1": ("src/repro_torch/csrc/level1.cu", "src/repro/kernels/level1.py:78"),
               "cholinv": ("src/repro_torch/csrc/cholinv.cu", "src/repro/kernels/cholinv.py:81"),
               "cisweep": ("src/repro_torch/csrc/cisweep.cu", "src/repro/kernels/cisweep.py:50"),
               "sgrid": ("src/repro_torch/csrc/sgrid.cu", "src/repro/kernels/sgrid.py:170"),
               "skernel": ("src/repro_torch/csrc/skernel.cu", "src/repro/kernels/cholinv.py:81, "
                           "src/repro/kernels/cisweep.py:50"),
               "gsq": ("src/repro_torch/csrc/gsq.cu", "src/repro/kernels/gsq.py:129")}
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep, launches=launches[name],
                    **rows[name]) for name, (src, rep) in sources.items()]
    for k in kernels:
        check(all(isinstance(v, (int, float)) and math.isfinite(v)
                  for key, v in k.items() if key in ("ms", "plain_ms", "bound_ms")),
              f"non-finite timing in {k}")
    print(smi.stdout.strip())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def gaussian(torch, rows, launches):
    """Phases 2 and 3: the Gaussian kernels and ``pc(x)`` on NCI-60."""
    from repro_torch import pc, pc_from_corr
    from repro_torch.core import engines, levels as L
    from repro_torch.core.cit import threshold
    from repro_torch.core.compact import compact_rows
    from repro_torch.data.synthetic_dag import sample_gaussian_dag
    from repro_torch.kernels import build, cholinv, cisweep, corr, level1, ops

    dev = torch.device("cuda")
    cfg = NCI60
    x_np, _ = sample_gaussian_dag(cfg["n"], cfg["m"], cfg["density"], seed=cfg["seed"])
    x = torch.tensor(x_np, dtype=torch.float32, device=dev)
    m, n, alpha = cfg["m"], cfg["n"], cfg["alpha"]
    tau = [threshold(m, ell, alpha) for ell in range(3)]

    # -------------------------------------------------------------- kernels
    # corr, at the main path's shape, the paper's §5.6 shape, a ragged one
    # (m not a multiple of the 32-sample slab or of its split, n not of the
    # 128-wide tile nor of 4) and the paper's two other small-m datasets with
    # many tiles (S.cerevisiae, S.aureus: src/repro/configs/cupc_datasets.py:
    # 26-27): atol 2e-6, bitwise symmetric, bitwise equal across two calls;
    # timed in turns with torch.matmul, and in a CUDA graph for the device
    # time alone (at m = 47 both calls are host-bound)
    corr_shapes = (("nci60", m, n, None), ("s5.6", 10000, 1000, (0.1, 1)),
                   ("ragged", 1003, 517, (0.1, 2)), ("S.cerevisiae", 63, 5361, (0.01, 3)),
                   ("S.aureus", 160, 2810, (0.01, 4)))
    for label, mm, nn, gen in corr_shapes:
        xs = x if gen is None else torch.tensor(
            sample_gaussian_dag(nn, mm, gen[0], seed=gen[1])[0], dtype=torch.float32, device=dev)
        xn = ops.standardize(xs).contiguous()
        got = corr.corr_matmul(xn)
        want = corr.corr_matmul_plain(xn)
        err = float((got - want).abs().max())
        symmetric = torch.equal(got, got.T)
        same = torch.equal(got, corr.corr_matmul(xn))
        reps = 50 if mm * nn * nn > 1e9 else 20
        l1_ms = cuda_ms(torch, lambda: torch.matmul(xn.T, xn), reps=reps)
        k1_ms = cuda_ms(torch, lambda: corr.corr_matmul(xn), reps=reps)
        k2_ms = cuda_ms(torch, lambda: corr.corr_matmul(xn), reps=reps)
        l2_ms = cuda_ms(torch, lambda: torch.matmul(xn.T, xn), reps=reps)
        k_ms, lib_ms = (k1_ms + k2_ms) / 2, (l1_ms + l2_ms) / 2
        kg_ms = graph_ms(torch, lambda: corr.corr_matmul(xn))
        lg_ms = graph_ms(torch, lambda: torch.matmul(xn.T, xn))
        p_ms = cuda_ms(torch, lambda: corr.corr_matmul_plain(xn))
        # the least work of XᵀX is its symmetric half: m·n·(n + 1) FLOPs
        b_ms, b_by = bound((mm * nn + nn * nn) * 4, mm * nn * (nn + 1))
        tile, tiles, splits, sps = corr.plan(mm, nn, torch.cuda.get_device_properties(dev)
                                             .multi_processor_count)
        print(f"kernel corr {label} m={mm} n={nn} ({tiles} tiles of {tile} x {splits} splits of "
              f"{sps} slabs): max_abs_err {err:.3g} (tol 2e-6), bitwise symmetric {symmetric}, "
              f"bitwise equal across calls {same}; kernel {k1_ms:.4f}/{k2_ms:.4f} ms, "
              f"torch.matmul {l1_ms:.4f}/{l2_ms:.4f} ms (kernel faster: {k_ms < lib_ms}); "
              f"in a CUDA graph kernel {kg_ms:.4f} ms, torch.matmul {lg_ms:.4f} ms; "
              f"plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; the full 2·m·n² product: "
              f"{bound((mm * nn + nn * nn) * 4, 2 * mm * nn * nn)[0]:.4f} ms)")
        check(err <= 2e-6, f"corr m={mm} n={nn} disagrees with its plain version: {err}")
        check(symmetric and same, f"corr m={mm} n={nn} is not bitwise symmetric and repeatable")
        if label == "nci60":
            rows["corr"] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                                bound_by=b_by, library_ms=lib_ms)

    # level0 on C: both entries exact against their plain versions
    c = ops.correlation(x)
    rows["level0"] = level0_phase(torch, "NCI-60", c, tau[0])
    adj0, sep0, _ = ops.level0_span(c, tau[0], 8)

    # level1 on the level-0 adjacency
    rem_k, kwin_k = level1.level1_dense_kernel(c, adj0, tau[1])
    rem_p, kwin_p = level1.level1_dense_plain(c, adj0, tau[1])
    rem_lo, kwin_lo = level1.level1_dense_plain(c, adj0, tau[1] - BAND)
    rem_hi, kwin_hi = level1.level1_dense_plain(c, adj0, tau[1] + BAND)
    d_rem, o_rem = band_diff(rem_k, rem_p, rem_lo, rem_hi)
    d_kw, o_kw = band_diff(kwin_k, kwin_p, kwin_lo, kwin_hi)
    outside = ((rem_k != rem_p) | (kwin_k != kwin_p)) & (rem_lo == rem_hi) & (kwin_lo == kwin_hi)
    err = float(torch.where(outside, (kwin_k - kwin_p).abs().float(), 0.0).max()) if o_kw else 0.0
    err = max(err, 1.0 if o_rem else 0.0)
    k_ms = cuda_ms(torch, lambda: level1.level1_dense_kernel(c, adj0, tau[1]), reps=10)
    p_ms = cuda_ms(torch, lambda: level1.level1_dense_plain(c, adj0, tau[1]), reps=3, warmup=1)
    # cells the data needs: masked-in k of alive edges, up to the least own
    # separator when there is one (after it neither output can change)
    cells = 0
    ks = torch.arange(n, device=dev)
    for i0 in range(0, n, 64):
        i1 = min(n, i0 + 64)
        ri = torch.arange(i0, i1, device=dev)
        alive = adj0[i0:i1] & (ri[:, None] != ks[None, :])
        kmask = (adj0[i0:i1, None, :] | adj0[None, :, :]) & (ks[None, None, :] != ri[:, None, None])
        kmask &= ks[None, None, :] != ks[None, :, None]
        stop = torch.where(kwin_p[i0:i1] < level1.BIG, kwin_p[i0:i1], n - 1)
        cells += int((kmask & alive[:, :, None] & (ks[None, None, :] <= stop[:, :, None])).sum())
    b_ms, b_by = bound(10 * n * n, L1_OPS_PER_CELL * cells)
    # 32-k steps: a pair is done at the chunk of its least own separator
    # (its `found` is set by then), else it walks every k. A pair's own
    # walk takes its own steps; the earlier design walked a 16×16 tile of pairs
    # in lockstep until its slowest alive pair was done; the kernel's warp
    # takes 128 k a step
    alive0 = adj0 & ~torch.eye(n, dtype=torch.bool, device=dev)
    stop = torch.where(kwin_p < level1.BIG, kwin_p, n - 1)
    steps = torch.where(alive0, stop // 32 + 1, 0)
    pair_steps = int(steps.sum())
    warp128 = torch.where(alive0, stop // 128 + 1, 0)
    warp_steps = int(warp128.sum())
    row_steps = warp128.sum(dim=1, dtype=torch.int64)
    pad = (-n) % 16
    tiles = torch.nn.functional.pad(steps, (0, pad, 0, pad)).reshape(
        (n + pad) // 16, 16, (n + pad) // 16, 16).amax(dim=(1, 3))
    tile_steps = int(tiles.sum())
    print(f"kernel level1 n={n}: removed differs in {d_rem} cells ({o_rem} outside the τ band), "
          f"kwin differs in {d_kw} ({o_kw} outside); kernel {k_ms:.4f} ms plain {p_ms:.4f} ms "
          f"bound {b_ms:.4f} ms ({b_by}, {cells} tested cells); 32-k steps: the pairs' own "
          f"walks {pair_steps} over {int(alive0.sum())} alive pairs, 16×16 lockstep "
          f"tiles {tile_steps} block-steps = {tile_steps * 256} pair-steps "
          f"({tile_steps * 256 / max(pair_steps, 1):.2f}× the pairs' own); the kernel's "
          f"128-k warp steps {warp_steps} (a row's: mean {float(row_steps.float().mean()):.1f}, "
          f"max {int(row_steps.max())})")
    check(o_rem == 0 and o_kw == 0, "level1 decisions differ outside the τ band")
    rows["level1"] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                          bound_by=b_by, library_ms=None)

    # cholinv and cisweep on the first ℓ = 2 chunk of the run
    adj1, _sep1, _ = engines.run_level(c, adj0, sep0, 1, tau[1])
    ell = 2
    npr = int(adj1.sum(1).max())
    npr_b, n_chunk, total = L.plan_level(npr, ell, n, n_cols=n)
    compact, counts = compact_rows(adj1, n_prime=npr_b)
    ranks = torch.arange(n_chunk, dtype=torch.int32, device=dev)
    rows_i = torch.arange(n, dtype=torch.int32, device=dev)
    m2, ci_s, cj_s, cij, mask, _ = L.gather_s(c, adj1, compact, counts, rows_i, ranks,
                                              ell=ell, n_max=npr_b)
    b = n * n_chunk
    m2 = m2.reshape(b, ell, ell).contiguous()
    ci_s = ci_s.reshape(b, ell).contiguous()
    cj_s = cj_s.reshape(b, npr_b, ell).contiguous()
    cij = cij.reshape(b, npr_b).contiguous()
    mask = mask.reshape(b, npr_b).contiguous()
    print(f"ℓ=2 chunk: max degree {npr} (bucket {npr_b}), {total} ranks, chunk {n_chunk}, "
          f"B={b} sets x P={npr_b} slots, {int(mask.sum())} masked-in cells")
    g_k, u_k, v_k = cholinv.cholinv(m2, ci_s)
    g_p, u_p, v_p = cholinv.cholinv_plain(m2, ci_s)
    err = max(float((a - p).abs().max()) for a, p in ((g_k, g_p), (u_k, u_p), (v_k, v_p)))
    close = all(torch.allclose(a, p, rtol=1e-5, atol=1e-6)
                for a, p in ((g_k, g_p), (u_k, u_p), (v_k, v_p)))
    k_ms = cuda_ms(torch, lambda: cholinv.cholinv(m2, ci_s))
    p_ms = cuda_ms(torch, lambda: cholinv.cholinv_plain(m2, ci_s))
    b_ms, b_by = bound(b * (2 * ell * ell + 2 * ell + 1) * 4, b * cholinv_ops(ell))
    print(f"kernel cholinv ℓ={ell} B={b}: max_abs_err {err:.3g} (rtol 1e-5, atol 1e-6) "
          f"kernel {k_ms:.4f} ms plain {p_ms:.4f} ms bound {b_ms:.5f} ms ({b_by})")
    check(close, f"cholinv disagrees with its plain version: max_abs_err {err}")
    rows["cholinv"] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                           bound_by=b_by, library_ms=None)

    got = cisweep.cisweep(g_k, u_k, v_k, cj_s, cij, mask, tau[2])
    want = cisweep.cisweep_plain(g_k, u_k, v_k, cj_s, cij, mask, tau[2])
    lo = cisweep.cisweep_plain(g_k, u_k, v_k, cj_s, cij, mask, tau[2] - BAND)
    hi = cisweep.cisweep_plain(g_k, u_k, v_k, cj_s, cij, mask, tau[2] + BAND)
    d_sw, o_sw = band_diff(got, want, lo, hi)
    k_ms = cuda_ms(torch, lambda: cisweep.cisweep(g_k, u_k, v_k, cj_s, cij, mask, tau[2]))
    p_ms = cuda_ms(torch, lambda: cisweep.cisweep_plain(g_k, u_k, v_k, cj_s, cij, mask, tau[2]))
    cells_sw = b * npr_b
    b_ms, b_by = bound(b * (ell * ell + ell + 1) * 4 + cells_sw * (4 * ell + 4 + 1 + 1),
                       int(mask.sum()) * cisweep_ops(ell))
    print(f"kernel cisweep ℓ={ell}: decisions differ in {d_sw} cells ({o_sw} outside the τ band) "
          f"kernel {k_ms:.4f} ms plain {p_ms:.4f} ms bound {b_ms:.5f} ms ({b_by})")
    check(o_sw == 0, "cisweep decisions differ outside the τ band")
    rows["cisweep"] = dict(max_abs_err=1.0 if o_sw else 0.0, ms=k_ms, plain_ms=p_ms,
                           bound_ms=b_ms, bound_by=b_by, library_ms=None)
    rows["skernel"] = skernel_phase(torch, "NCI-60 first ℓ=2 chunk", c, adj1, tau[2])

    # sgrid at the first level-1 launch of "S-grid" (the fused entry), and
    # the gathered entry on seeded SPD launches at ℓ = 3 and ℓ = 8
    rows["sgrid"] = sgrid_fused_phase(torch, "NCI-60 first ℓ=1 launch", c, adj0, 1,
                                      L.GRID_CELL_BUDGET, tau[1])
    for ell, seed in ((3, 3), (8, 8)):
        sgrid_phase(torch, f"synthetic SPD ℓ={ell}",
                    synthetic_launch(torch, 1000, 64, 64, ell, seed, dev), 0.05)

    # ----------------------------------------------------------- end to end
    # a first run loads PyTorch's own CUDA modules (sort, unique, bmm, ...)
    # on first use; the measured run after it is the steady state
    t0 = time.monotonic()
    first = pc(x_np, alpha=alpha)
    first_s = time.monotonic() - t0
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.monotonic()
    run = pc(x_np, alpha=alpha)
    torch.cuda.synchronize()
    e2e_s = time.monotonic() - t0
    path = ("corr", "level0", "level1", "skernel")
    launches.update({k: build.LAUNCHES[k] for k in path})
    chunks = sum(st["chunks"] for st in run.level_stats if st["level"] >= 2)
    check((run.adj == first.adj).all() and (run.sepsets == first.sepsets).all(),
          "two runs of pc(x) on the card disagree")
    print(f"e2e pc(x) NCI-60 n={n} m={m}: {e2e_s:.3f} s (first run {first_s:.3f} s), "
          f"{run.levels_run} levels, {int(run.adj.sum()) // 2} edges, level0 span "
          f"{run.timings_s['level0']:.6f} s, timings {json.dumps(run.timings_s)}")
    for st in run.level_stats:
        print(f"  level {st['level']}: engine {st['engine']} max degree {st['npr']} "
              f"chunks {st['chunks']} {run.timings_s.get('level%d' % st['level'], 0.0):.4f} s")
    print(f"  launches {json.dumps(build.LAUNCHES)}")
    check(all(launches[k] > 0 for k in path),
          f"a kernel of the Gaussian path never launched: {build.LAUNCHES}")
    check(launches["level0"] == 1, f"the level-0 span launched level0 {launches['level0']} "
          "times, not once")
    check(launches["skernel"] == chunks and not build.LAUNCHES["cholinv"]
          and not build.LAUNCHES["cisweep"],
          f"auto launched skernel {launches['skernel']} times for {chunks} chunks at ℓ ≥ 2, or "
          f"cholinv or cisweep: {build.LAUNCHES}")
    c64 = ops.correlation(x).double().cpu().numpy()
    for ell, cnt in certify(run, c64, m, alpha, threshold).items():
        print(f"  certificate ℓ={ell}: {cnt['checked']} recorded sepsets pass in float64, "
              f"{cnt['band']} of them in the τ band, {cnt['fp32_undecidable']} past it but "
              "within their fp32 error bound (nearly collinear variables)")

    # the same C on the card and on the host CPU: decisions may differ only
    # through the ulps of rsqrtf/atanhf, so only inside the band
    sx, _ = sample_gaussian_dag(SMALL["n"], SMALL["m"], SMALL["density"], seed=SMALL["seed"])
    gpu = pc(sx, alpha=SMALL["alpha"])
    sc = ops.correlation(torch.tensor(sx, dtype=torch.float32, device=dev))
    cpu = pc_from_corr(sc.cpu(), SMALL["m"], alpha=SMALL["alpha"], device="cpu")
    sc64 = sc.double().cpu().numpy()
    n_diff, unexplained = explain_diffs(gpu, cpu, sc64, SMALL["m"], SMALL["alpha"], threshold)
    same_cpdag = bool((gpu.cpdag == cpu.cpdag).all())
    print(f"  n={SMALL['n']} CUDA vs CPU: {n_diff} edges differ ({unexplained} outside the τ band), "
          f"cpdag equal {same_cpdag}, {gpu.levels_run} levels")
    check(unexplained == 0, "CUDA and CPU runs differ outside the τ band")
    check(same_cpdag or n_diff > 0, "CPDAGs differ although skeleton and sepsets agree")
    gpu = pc(sx, alpha=SMALL["alpha"], engine="S-grid")
    cpu = pc_from_corr(sc.cpu(), SMALL["m"], alpha=SMALL["alpha"], device="cpu", engine="S-grid")
    n_diff, unexplained = explain_diffs(gpu, cpu, sc64, SMALL["m"], SMALL["alpha"], threshold)
    same_cpdag = bool((gpu.cpdag == cpu.cpdag).all())
    print(f"  n={SMALL['n']} S-grid CUDA vs CPU: {n_diff} edges differ ({unexplained} outside the "
          f"τ band), cpdag equal {same_cpdag}, {gpu.levels_run} levels")
    check(unexplained == 0, "S-grid CUDA and CPU runs differ outside the τ band")
    check(same_cpdag or n_diff > 0, "CPDAGs differ although skeleton and sepsets agree")

    # the same path with the reference's two kernels a chunk: the fused
    # kernel's winners are bitwise theirs, so the runs are bitwise equal
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.monotonic()
    two = pc(x_np, alpha=alpha, chunk_fn_s=ops.chunk_s_two_launch)
    torch.cuda.synchronize()
    two_s = time.monotonic() - t0
    launches.update({k: build.LAUNCHES[k] for k in ("cholinv", "cisweep")})
    print(f"e2e pc(x, chunk_fn_s=ops.chunk_s_two_launch) NCI-60: {two_s:.3f} s, launches "
          f"{json.dumps(build.LAUNCHES)}")
    level_lines(two)
    check(launches["cholinv"] == launches["cisweep"] == chunks > 0
          and not build.LAUNCHES["skernel"],
          f"the two-launch run launched cholinv/cisweep other than once a chunk: "
          f"{build.LAUNCHES}")
    check((two.adj == run.adj).all() and (two.sepsets == run.sepsets).all(),
          "the fused and the two-launch S-kernel runs differ")

    nci60_engines(torch, x_np, run, c64, launches, dev)
    return run


def discrete(torch, rows, launches):
    """Phases 4 and 5: the gsq kernel and ``pc(x, test="discrete")`` on the
    PIGS-shaped stand-in."""
    from repro_torch import pc
    from repro_torch.core import cit, engines, levels as L, stable_ref
    from repro_torch.core.compact import compact_rows
    from repro_torch.data.synthetic_dag import sample_discrete_dag
    from repro_torch.kernels import build, gsq

    dev = torch.device("cuda")
    cfg = PIGS
    n, m, alpha = cfg["n"], cfg["m"], cfg["alpha"]
    x_np, dag = discrete_codes(sample_discrete_dag, cfg)
    test, stats = cit.DiscreteCITest.from_samples(x_np, alpha=alpha, device=dev)
    r = test.r
    print(f"discrete stand-in (bnlearn PIGS shape): n={n} m={m} arity {r}, "
          f"{int(dag.adj.sum())} true arcs, α={alpha}")

    def gsq_phase(label, jc, q):
        """gsq against its plain version on jc, bitwise; timed."""
        b, mm = jc.shape
        got = gsq.gsq_cells(jc, r=r, q=q)
        want = gsq.gsq_ref(jc, r=r, q=q)
        n_diff = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        k_ms = cuda_ms(torch, lambda: gsq.gsq_cells(jc, r=r, q=q), reps=10)
        p_ms = cuda_ms(torch, lambda: gsq.gsq_ref(jc, r=r, q=q), reps=2, warmup=1)
        k_total = q * r * r
        b_ms, b_by = bound(4 * b * mm + 4 * b,
                           b * (mm * G2_OPS_PER_SAMPLE + k_total * G2_OPS_PER_TERM))
        print(f"kernel gsq {label}: M={mm} B={b} K={k_total}: {n_diff} cells differ from the "
              f"plain version (bitwise required); kernel {k_ms:.4f} ms plain {p_ms:.4f} ms "
              f"bound {b_ms:.4f} ms ({b_by})")
        check(n_diff == 0, f"gsq {label} differs from its plain version in {n_diff} cells")
        return dict(max_abs_err=float((got - want).abs().max()), ms=k_ms, plain_ms=p_ms,
                    bound_ms=b_ms, bound_by=b_by, library_ms=None)

    # ------------------------------------------------------- kernel: gsq
    codes_t = stats.codes.T.contiguous()
    jc = (codes_t[:, None, :] * r + codes_t[None, :, :]).reshape(n * n, m)
    rows["gsq"] = gsq_phase("level 0", jc, 1)
    flat = (jc.to(torch.int64) + torch.arange(n * n, device=dev)[:, None] * (r * r)).reshape(-1)
    print(f"  note: torch.bincount of the same codes (the counts alone, no G²) "
          f"{cuda_ms(torch, lambda: torch.bincount(flat, minlength=n * n * r * r), reps=5):.4f} ms")
    del jc, flat

    # the first chunk of every level ℓ = 1…5 of the run, each level's
    # adjacency from the level before it
    adj = test.level0(stats, alpha)
    sep = torch.full((n, n, 8), -1, dtype=torch.int32, device=dev)
    sep[:, :, 0] = torch.where(adj, -1, -2).to(torch.int32)
    for ell in range(1, test.max_supported_level() + 1):
        npr = int(adj.sum(1).max())
        if npr - 1 < ell:
            print(f"ℓ={ell}: max degree {npr}, no conditioning set of size {ell}")
            break
        budget = L.DEFAULT_CELL_BUDGET * ell * ell // m  # engines.run_level's rescale
        npr_b, n_chunk, total = L.plan_level(npr, ell, n, cell_budget=budget, n_cols=n)
        compact, counts = compact_rows(adj, n_prime=npr_b)
        ranks = torch.arange(n_chunk, dtype=torch.int32, device=dev)
        jc, _dof, mask, _ = L.g2_worklist(stats, adj, compact, counts, ranks, ell=ell,
                                          n_max=npr_b, r=r)
        print(f"ℓ={ell} chunk: max degree {npr} (bucket {npr_b}), {total} ranks, "
              f"chunk {n_chunk}, {int(mask.sum())} masked-in of {jc.shape[0]} cells")
        gsq_phase(f"ℓ={ell} chunk", jc, r**ell)
        del jc
        adj, sep, _ = engines.run_level(stats, adj, sep, ell, alpha, test=test)

    # ---------------------------------------------------------- end to end
    t0 = time.monotonic()
    first = pc(x_np, alpha=alpha, test="discrete")
    first_s = time.monotonic() - t0
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.monotonic()
    run = pc(x_np, alpha=alpha, test="discrete")
    torch.cuda.synchronize()
    e2e_s = time.monotonic() - t0
    launches["gsq"] = build.LAUNCHES["gsq"]
    check((run.adj == first.adj).all() and (run.sepsets == first.sepsets).all(),
          "two runs of pc(x, test='discrete') on the card disagree")
    print(f"e2e pc(x, test='discrete') n={n} m={m}: {e2e_s:.3f} s (first run {first_s:.3f} s), "
          f"{run.levels_run} levels (cap {test.max_supported_level()}), "
          f"{int(run.adj.sum()) // 2} edges, timings {json.dumps(run.timings_s)}")
    for st in run.level_stats:
        print(f"  level {st['level']}: engine {st['engine']} max degree {st['npr']} "
              f"chunks {st['chunks']} {run.timings_s.get('level%d' % st['level'], 0.0):.4f} s")
    print(f"  launches {json.dumps(build.LAUNCHES)}")
    check(launches["gsq"] > 0 and all(st["engine"] == "G2-kernel" for st in run.level_stats),
          f"the discrete path did not run through gsq: {build.LAUNCHES}")
    for ell, cnt in certify_g2(run, x_np, r, alpha).items():
        print(f"  certificate ℓ={ell}: {cnt['checked']} recorded sepsets pass in float64, "
              f"{cnt['band']} of them in the p band, {cnt['fp32_undecidable']} past it but "
              "within their fp32 error bound")

    # the same codes on the card and on the host CPU
    ds = D_SMALL
    sx, _ = discrete_codes(sample_discrete_dag, ds)
    gpu = pc(sx, alpha=ds["alpha"], test="discrete")
    cpu = pc(sx, alpha=ds["alpha"], test="discrete", device="cpu")
    n_diff, unexplained = explain_g2_diffs(gpu, cpu, sx, int(sx.max()) + 1, ds["alpha"])
    same_cpdag = bool((gpu.cpdag == cpu.cpdag).all())
    print(f"  n={ds['n']} m={ds['m']} CUDA vs CPU: {n_diff} edges differ ({unexplained} outside "
          f"the p band), cpdag equal {same_cpdag}, {gpu.levels_run} levels, "
          f"{int(gpu.adj.sum()) // 2} edges")
    check(unexplained == 0, "discrete CUDA and CPU runs differ outside the p band")
    check(same_cpdag or n_diff > 0, "CPDAGs differ although skeleton and sepsets agree")

    do = D_ORACLE
    ox, _ = discrete_codes(sample_discrete_dag, do)
    got = pc(ox, alpha=do["alpha"], test="discrete", max_level=2)
    want = stable_ref.pc_stable_skeleton_discrete(ox, alpha=do["alpha"], max_level=2)
    same = bool((got.adj == want.adj).all())
    print(f"  n={do['n']} m={do['m']} against the float64 serial oracle at max_level 2: "
          f"skeleton equal {same}, {int(got.adj.sum()) // 2} edges")
    check(same, "the discrete skeleton differs from the float64 serial oracle")


def spent(torch, t0):
    """Seconds since t0, once the card has finished its work."""
    torch.cuda.synchronize()
    return time.monotonic() - t0


def kernel_time(torch, fn):
    """(summed device time in ms of the kernels that one call of ``fn``
    runs, their count, the hand kernels among them counted by the names of
    ``build.LAUNCHES``) from a ``torch.profiler`` trace after a warm call;
    (None, 0, {}) when the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.analysis.cuda import kernel_label

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    if not busy:
        return None, 0, {}
    traced = {}
    for e in busy:
        name = kernel_label(e.key)
        if name is not None:
            traced[name] = traced.get(name, 0) + e.count
    return (sum(e.self_device_time_total for e in busy) / 1e3, sum(e.count for e in busy),
            traced)


def replay_kernels(torch, prog, label):
    """Hold a program's graphs and a traced replay to its counted launches:
    the hand kernels among its kernel nodes must equal the counts; a
    ``torch.profiler`` trace of one replay (up to three, until one holds
    an event for every graph node) must show them, or, where every trace
    lost records, no more of any. Returns (replay's busy ms, device events
    traced, hand kernels traced, kernel nodes)."""
    from repro_torch.analysis.cuda import graph_kernels

    counted = nonzero(prog.launches)
    census, kernel_nodes = graph_kernels(prog)
    check(census == counted,
          f"{label}: its graphs hold the hand kernels {census}, not the counted {counted}")
    for _ in range(3):
        busy_ms, events, traced = kernel_time(torch, prog.launch)
        if events == sum(prog.nodes):
            break
    if events == sum(prog.nodes):
        check(traced == counted, f"{label}: a traced replay ran {traced}, not {counted}")
    else:
        print(f"  {label}: each of three traces lost records (the last {events} device events "
              f"of {sum(prog.nodes)} graph nodes); the trace is held to at most the counts")
        check(set(traced) <= set(counted) and all(traced[k] <= counted[k] for k in traced),
              f"{label}: a traced replay ran {traced}, beyond {counted}")
    return busy_ms, events, traced, kernel_nodes


def nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def batch(torch, card):
    """Phase 6: the batch subsystem on the card. Each of its paths runs with
    the counts reset just before and read just after; ``card`` is the
    nvidia-smi name and power limit printed beside each time."""
    from repro_torch.kernels import build

    batch_many(torch, card, build)
    boot = batch_bootstrap(torch, card, build)
    batch_discrete(torch, card, build)
    return boot


def batch_many(torch, card, build):
    """(a) The reference's many-graph workload (benchmarks/pc_batch.py:46-49
    FULL_CONFIGS["sparse"]): ``plan_schedule``, then ``pc_scan_batch`` on
    the schedule, one CUDA graph recorded once and replayed; every lane
    bitwise the port's "S-kernel" at the same cap; graphs/s of the replay
    beside the sequential loop of ``pc_from_corr(engine="auto")``; an α
    sweep on lane 0's C; four lanes against the port's CPU run."""
    from repro_torch import pc_from_corr
    from repro_torch.batch import capture, scan_pc
    from repro_torch.core import levels as L
    from repro_torch.core.cit import threshold
    from repro_torch.data.synthetic_dag import sample_gaussian_dag
    from repro_torch.kernels import ops

    cfg = BATCH
    b, n, m, alpha, lmax = cfg["B"], cfg["n"], cfg["m"], cfg["alpha"], cfg["max_level"]
    dev = torch.device("cuda")
    cs = torch.stack([ops.correlation(torch.tensor(
        sample_gaussian_dag(n, m, cfg["density"], seed=cfg["seed"] + k)[0], dtype=torch.float32,
        device=dev)) for k in range(b)])
    kw = dict(alpha=alpha, max_level=lmax, orient=False, device=dev)
    capture.clear()
    t0 = time.monotonic()
    schedule = scan_pc.plan_schedule(cs, m, alpha=alpha, max_level=lmax, bucket=False,
                                     device=dev)
    plan_s = spent(torch, t0)
    budget = max(L.DEFAULT_CELL_BUDGET // b, 2**16)
    plan = [scan_pc._plan_chunk(n, w, ell, budget) for ell, w in enumerate(schedule, 1)]
    dense = scan_pc._use_dense_l1(n, schedule[0], budget)
    t0 = time.monotonic()
    first = scan_pc.pc_scan_batch(cs, m, n_prime=schedule, **kw)
    record_s = spent(torch, t0)
    prog = capture.programs()[-1]
    print(f"batch (a) many graphs: B={b} n={n} m={m} density {cfg['density']} α={alpha} "
          f"max_level {lmax}, seeds {cfg['seed']}+b; schedule {schedule} (plan_schedule "
          f"{plan_s:.3f} s), (n_chunk, steps) per level {plan}, dense ℓ=1 {dense}; first call "
          f"(eager run, capture, first replay) {prog.record_s:.3f} s of {record_s:.3f} s, "
          f"the graph's launches {json.dumps(prog.launches)}  [{card}]")

    torch.cuda.synchronize()
    build.reset_launches()
    reps, times = 5, []
    for _ in range(reps):
        t0 = time.monotonic()
        res = scan_pc.pc_scan_batch(cs, m, n_prime=schedule, **kw)
        times.append(spent(torch, t0))
    got = dict(build.LAUNCHES)
    want = {k: reps * prog.launches.get(k, 0) for k in got}
    steps = sum(s for ell, (_, s) in enumerate(plan, 1) if not (ell == 1 and dense))
    print(f"  {reps} replays: {', '.join(f'{t:.4f}' for t in times)} s, "
          f"{b / min(times):.1f} graphs/s best, launches {json.dumps(got)}")
    check(got == want, f"the replays' launches {got} are not {reps} × the graph's {want}")
    check(got["level0"] == reps * b and got["skernel"] > 0 and not got["corr"],
          f"a replay did not launch level0 once a lane and skernel: {got}")
    check(got["skernel"] <= reps * b * steps, f"skernel launched {got['skernel']} times, more "
          f"than {reps} × {b} lanes × {steps} planned steps")
    check(all(torch.equal(getattr(first, f), getattr(res, f)) for f in res._fields),
          "two calls of pc_scan_batch on the card disagree")
    check(bool(res.ok.all()), f"ok is False for lanes {torch.nonzero(~res.ok).flatten().tolist()}")
    replay_ms = cuda_ms(torch, prog.launch, reps=5, warmup=1)
    busy_ms, kernels, traced, total = replay_kernels(torch, prog, "(a)")
    print(f"  one replay: {replay_ms:.3f} ms between CUDA events, its {kernels} kernels "
          f"{busy_ms if busy_ms is None else round(busy_ms, 3)} ms busy (torch.profiler), "
          f"graphs of {prog.nodes} nodes ({total} kernel nodes); hand kernels in the graphs and "
          f"traced {json.dumps(traced)}  [{card}]")

    engine = "auto" if dense else "S-kernel"
    for k in range(b):
        ref = pc_from_corr(cs[k], m, alpha=alpha, engine=engine, max_level=lmax, orient=False,
                           device=dev)
        check((res.adj[k].cpu().numpy() == ref.adj).all()
              and (res.sepsets[k].cpu().numpy() == ref.sepsets).all(),
              f"lane {k} differs from pc_from_corr(engine={engine!r}) at the same cap")
    for _ in range(2):  # the first loop warms PyTorch's modules
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for k in range(b):
            pc_from_corr(cs[k], m, alpha=alpha, max_level=lmax, orient=False, device=dev)
        loop_s = spent(torch, t0)
    print(f"  every lane bitwise pc_from_corr(engine={engine!r}, max_level={lmax}); the "
          f"sequential loop of pc_from_corr(engine='auto') {loop_s:.3f} s = "
          f"{b / loop_s:.1f} graphs/s, replay {b / min(times):.1f} graphs/s  [{card}]")

    alphas = SWEEP_ALPHAS
    t0 = time.monotonic()
    sweep = scan_pc.alpha_sweep(cs[0], m, alphas, max_level=lmax, orient=False, device=dev)
    sweep_s = spent(torch, t0)
    for k, a in enumerate(alphas):
        solo = scan_pc.pc_scan(cs[0], m, alpha=a, max_level=lmax, orient=False, device=dev)
        check(torch.equal(sweep.adj[k], solo.adj) and torch.equal(sweep.sepsets[k], solo.sepsets),
              f"alpha_sweep lane α={a} differs from pc_scan at that α")
    print(f"  alpha_sweep α ∈ {alphas} on lane 0's C: {sweep_s:.3f} s with its capture, edges "
          f"{[int(a.sum()) // 2 for a in sweep.adj]}, each lane bitwise pc_scan at its α, ok "
          f"{bool(sweep.ok.all())}  [{card}]")
    check(bool(sweep.ok.all()), "alpha_sweep flagged a lane")

    cpu = scan_pc.pc_scan_batch(cs[:4].cpu(), m, alpha=alpha, max_level=lmax, n_prime=schedule,
                                orient=False, device="cpu")
    for k in range(4):
        c64 = cs[k].double().cpu().numpy()
        n_diff, unexplained = explain_diffs(
            SimpleNamespace(adj=res.adj[k].cpu().numpy(), sepsets=res.sepsets[k].cpu().numpy()),
            SimpleNamespace(adj=cpu.adj[k].numpy(), sepsets=cpu.sepsets[k].numpy()), c64, m,
            alpha, threshold)
        print(f"  lane {k} CUDA vs CPU: {n_diff} edges differ ({unexplained} outside the τ band "
              f"and fp32 bound), {int(res.adj[k].sum()) // 2} edges")
        check(unexplained == 0, f"lane {k} differs from the CPU run outside the τ band")
    capture.clear()


def batch_bootstrap(torch, card, build):
    """(b) ``bootstrap_pc`` on the NCI-60 stand-in (Table 1's shape), the
    level-synced path (one CUDA graph a level), run twice: the second run
    replays every graph, and its counts are the path's. Returns the first
    call's seconds and the skernel steps it recorded (phase 7's model of a
    first call)."""
    import numpy as np

    from repro_torch import pc_from_corr
    from repro_torch.analysis.cuda import graph_kernels
    from repro_torch.batch import capture, ensemble, scan_pc
    from repro_torch.core import levels as L, orient
    from repro_torch.data.synthetic_dag import sample_gaussian_dag

    cfg, nb = NCI60, BOOT_REPLICATES
    n, m, alpha = cfg["n"], cfg["m"], cfg["alpha"]
    dev = torch.device("cuda")
    x_np, _ = sample_gaussian_dag(n, m, cfg["density"], seed=cfg["seed"])
    x = torch.tensor(x_np, dtype=torch.float32, device=dev)
    capture.clear()
    t0 = time.monotonic()
    first = ensemble.bootstrap_pc(x, n_boot=nb, alpha=alpha, seed=0, device=dev)
    first_s = spent(torch, t0)
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.monotonic()
    run = ensemble.bootstrap_pc(x, n_boot=nb, alpha=alpha, seed=0, device=dev)
    run_s = spent(torch, t0)
    got = dict(build.LAUNCHES)
    print(f"batch (b) bootstrap_pc NCI-60 n={n} m={m} n_boot={nb} seed 0: first call "
          f"{first_s:.3f} s (records one graph a level), second {run_s:.3f} s, spans "
          f"{json.dumps({k: round(v, 6) for k, v in run.timings_s.items()})}, schedule "
          f"{run.schedule}, launches {json.dumps(got)}  [{card}]")
    check(np.array_equal(first.replicate_adj, run.replicate_adj)
          and np.array_equal(first.cpdag, run.cpdag), "two bootstrap_pc runs disagree")

    idx = ensemble.resample_indices(nb, m, seed=0)
    cs = ensemble.bootstrap_corr(x, idx)
    build.reset_launches()
    res, schedule = scan_pc.scan_levels_batch(cs, m, alpha=alpha, orient=False, device=dev)
    check(got == {k: v + (nb if k == "corr" else 0) for k, v in build.LAUNCHES.items()},
          f"bootstrap_pc launched {got}, its corr and scan alone {build.LAUNCHES}")
    budget = max(L.DEFAULT_CELL_BUDGET // nb, 2**16)
    planned, levels = 0, []
    for ell, w in enumerate(schedule, 1):
        if int(res.max_degs[:, ell - 1].max()) - 1 < ell:
            levels.append((ell, w, "skipped"))
            continue
        check(not (ell == 1 and scan_pc._use_dense_l1(n, w, budget)), "NCI-60 ℓ=1 went dense")
        n_chunk, steps = scan_pc._plan_chunk(n, w, ell, budget)
        levels.append((ell, w, n_chunk, steps))
        planned += nb * steps
    print(f"  levels (ℓ, width, n_chunk, steps a lane): {levels}; skernel planned {planned}")
    check(got["corr"] == nb and got["level0"] == nb and got["skernel"] == planned,
          f"bootstrap_pc launched corr {got['corr']}, level0 {got['level0']}, skernel "
          f"{got['skernel']} times, not {nb}, {nb} and {planned}")
    check(np.array_equal(res.adj.cpu().numpy(), run.replicate_adj),
          "scan_levels_batch on the replicates' C differs from bootstrap_pc's replicates")
    check(run.replicate_ok.all(), "a replicate is flagged degree-capped")
    level1 = next(p for p in capture.programs() if p.key[:2] == ("scan_level", 1))
    l1_ms = cuda_ms(torch, level1.launch, reps=2, warmup=1)
    l1_busy, l1_kernels, l1_traced, l1_total = replay_kernels(torch, level1, "(b) ℓ=1")
    for prog in capture.programs():
        if prog is not level1:
            census, _ = graph_kernels(prog)
            check(census == nonzero(prog.launches), f"(b) {prog.key[:2]}: its graphs hold "
                  f"{census}, not the counted {prog.launches}")
    call_busy, call_kernels, call_traced = kernel_time(torch, lambda: ensemble.bootstrap_pc(
        x, n_boot=nb, alpha=alpha, seed=0, device=dev))
    print(f"  ℓ=1 program replay {l1_ms:.3f} ms between CUDA events, its {l1_kernels} kernels "
          f"{l1_busy} ms busy, graphs of {level1.nodes} nodes ({l1_total} kernel nodes), hand "
          f"kernels in the graphs and traced {json.dumps(l1_traced)}; every program's graphs "
          f"hold its counted kernels; a steady call's {call_kernels} kernels {call_busy} ms "
          f"busy, hand kernels traced {json.dumps(call_traced)} (torch.profiler)  [{card}]")
    check(all(v <= got.get(k, 0) for k, v in call_traced.items()),
          f"a traced bootstrap_pc call ran {call_traced}, beyond the counted {got}")
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for k in range(nb):
        ref = pc_from_corr(cs[k], m, alpha=alpha, engine="S-kernel", max_level=3, orient=False,
                           device=dev)
        check((run.replicate_adj[k] == ref.adj).all()
              and (res.sepsets[k].cpu().numpy() == ref.sepsets).all(),
              f"replicate {k} differs from pc_from_corr(c_b, engine='S-kernel', max_level=3)")
    loop_s = spent(torch, t0)
    print(f"  the {nb} replicates through pc_from_corr(engine='S-kernel', max_level=3) one by "
          f"one: {loop_s:.3f} s with the checks  [{card}]")
    freq = run.replicate_adj.sum(axis=0).astype(np.float32) * (np.float32(1) / np.float32(nb))
    check(np.array_equal(run.edge_freq, freq), "edge_freq is not the replicates' mean")
    # the vote again, by a scatter of the recorded ids (not sepset_membership)
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    removed = ~res.adj & ~eye
    votes = torch.zeros(n * n * n, dtype=torch.int32, device=dev)
    for k in range(nb):
        sep = res.sepsets[k]
        i, j, slot = torch.nonzero((sep >= 0) & removed[k][..., None], as_tuple=True)
        votes.index_add_(0, (i * n + j) * n + sep[i, j, slot].long(),
                         torch.ones_like(i, dtype=torch.int32))
    member = votes.view(n, n, n) * 2 > removed.sum(0, dtype=torch.int32)[..., None]
    del votes
    cpdag = orient.cpdag_from_membership(torch.tensor(run.adj, device=dev), member)
    check(np.array_equal(cpdag.cpu().numpy(), run.cpdag),
          "the ensemble CPDAG differs from the recomputed vote's")
    print(f"  every replicate bitwise pc_from_corr(engine='S-kernel', max_level=3); "
          f"{int(run.adj.sum()) // 2} stable edges; CPDAG equal to the recomputed vote's; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    del member, cs, res
    capture.clear()
    torch.cuda.empty_cache()
    return dict(first_s=first_s, steps=planned)


def batch_discrete(torch, card, build):
    """(c) ``pc(codes, test="discrete", engine="scan")`` on the PIGS
    stand-in, bitwise the host loop's "G2-kernel" at the same cap: cap 2,
    then the default cap 3 where cap 2's first call per step predicts that
    it takes at most ``DISCRETE_SCAN_S``."""
    from repro_torch.batch import scan_pc
    from repro_torch.core import cit, levels as L
    from repro_torch.data.synthetic_dag import sample_discrete_dag

    cfg = PIGS
    n, m = cfg["n"], cfg["m"]
    x_np, _ = discrete_codes(sample_discrete_dag, cfg)
    test, stats = cit.DiscreteCITest.from_samples(x_np, alpha=cfg["alpha"], device="cuda")
    w = max(1, min(L.bucket_npr(int(L.max_degree(test.level0(stats, cfg["alpha"])))), n))
    steps = {ell: scan_pc._plan_chunk(n, w, ell, L.DEFAULT_CELL_BUDGET, m=m)[1]
             for ell in (1, 2, 3)}
    print(f"batch (c) discrete scan, PIGS stand-in n={n} m={m}: level-0 width {w}, steps a "
          f"level {steps}")
    first_s = discrete_scan(torch, card, build, x_np, w, 2)
    per_step = first_s / (steps[1] + steps[2])
    predicted = per_step * sum(steps.values())
    print(f"  cap 3: its first call predicted {predicted:.1f} s from cap 2's "
          f"{per_step * 1e3:.3f} ms a step: "
          + ("run" if predicted <= DISCRETE_SCAN_S else f"not run (over {DISCRETE_SCAN_S:.0f} s)"))
    if predicted <= DISCRETE_SCAN_S:
        discrete_scan(torch, card, build, x_np, w, 3)


def discrete_scan(torch, card, build, x_np, w, cap):
    """The discrete scan at ``cap``: a recording call, then a steady call
    whose launches are counted and held to the plan; both bitwise
    "G2-kernel" at the same cap. Returns the first call's seconds."""
    import numpy as np

    from repro_torch import pc
    from repro_torch.batch import capture, scan_pc
    from repro_torch.core import levels as L

    cfg = PIGS
    n, m = cfg["n"], cfg["m"]
    capture.clear()
    t0 = time.monotonic()
    run = pc(x_np, alpha=cfg["alpha"], test="discrete", engine="scan", max_level=cap)
    run_s = spent(torch, t0)
    (prog,) = capture.programs()
    build.reset_launches()
    t0 = time.monotonic()
    again = pc(x_np, alpha=cfg["alpha"], test="discrete", engine="scan", max_level=cap)
    again_s = spent(torch, t0)
    got = dict(build.LAUNCHES)
    pc(x_np, alpha=cfg["alpha"], test="discrete", engine="G2-kernel", max_level=cap)
    t0 = time.monotonic()
    ref = pc(x_np, alpha=cfg["alpha"], test="discrete", engine="G2-kernel", max_level=cap)
    ref_s = spent(torch, t0)
    # a call: level 0 once to plan the width (eager), then the replay: level
    # 0 again and one gsq launch a step of every level
    l0_blocks = -(-n // max(1, L.LEVEL0_JC_BYTES // (4 * n * m)))
    planned = sum(scan_pc._plan_chunk(n, w, ell, L.DEFAULT_CELL_BUDGET, m=m)[1]
                  for ell in range(1, cap + 1))
    print(f"  cap {cap}: host loop pc(engine='G2-kernel') {ref_s:.3f} s; scan first call "
          f"{run_s:.3f} s (recording {prog.record_s:.3f} s, graphs of {prog.nodes} nodes), a "
          f"steady call {again_s:.3f} s, {run.levels_run} levels, {int(run.adj.sum()) // 2} "
          f"edges; a steady call's launches {json.dumps(nonzero(got))} = level 0's "
          f"{l0_blocks} row blocks twice + {planned} steps  [{card}]")
    check(got == {**{k: 0 for k in got}, "gsq": 2 * l0_blocks + planned},
          f"a steady discrete scan launched {got}, not gsq {l0_blocks} × 2 + {planned}")
    check(prog.launches["gsq"] == l0_blocks + planned,
          f"the discrete graph holds {prog.launches['gsq']} gsq launches, not "
          f"{l0_blocks} + {planned}")
    for other, name in ((again, "its replay"), (ref, "pc(engine='G2-kernel')")):
        check(np.array_equal(run.adj, other.adj) and np.array_equal(run.sepsets, other.sepsets)
              and np.array_equal(run.cpdag, other.cpdag),
              f"the discrete scan differs from {name} at cap {cap}")
    capture.clear()
    return run_s


# phase 7: pc_serve's stream at the reference's many-graph shape
# (benchmarks/pc_batch.py:46-49, "sparse"): 64 requests alternating n = 96
# and n = 48 (pc_serve's two bucket shapes), one α sweep, cap 3, slots of 8,
# open-loop Poisson arrivals at 50 requests/s, seed 0
SERVE_ARGV = ("--requests", "64", "--n", "96", "--m", "3000", "--density", "0.015",
              "--alpha", "0.01", "--max-level", "3", "--slot-size", "8", "--rate", "50",
              "--seed", "0")
# the §5.6 request runs at cap 2 where its first call is predicted under
# this many seconds, else at cap 1
SERVE_S56_FIRST_S = 60.0


def serving(torch, card, auto, auto56, boot):
    """Phase 7: the launchers and ``PCService`` on the card. ``auto`` and
    ``auto56`` are phase 3's "auto" runs on NCI-60 and §5.6, ``boot`` phase
    6 (b)'s first call (its seconds and recorded steps)."""
    import shutil
    import tempfile

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        serve_pc_run(torch, card, auto, tmp)
        svc = serve_stream(torch, card)
        serve_s56(torch, card, auto56, boot)
        serve_faults(torch, card)
        serve_scrape(svc)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return svc


def serve_pc_run(torch, card, auto, tmp):
    """(a) ``pc_run``: NCI-60 in a subprocess, equal to phase 3's "auto";
    ``--batch`` on the batch cell's lanes, its schedule ``plan_schedule``'s;
    ``--bootstrap`` with a journal, equal to ``bootstrap_pc``."""
    import os

    from repro_torch import obs
    from repro_torch.batch import capture, ensemble, scan_pc
    from repro_torch.data.synthetic_dag import sample_gaussian_dag
    from repro_torch.kernels import build, ops
    from repro_torch.launch import pc_run

    dev = torch.device("cuda")
    out = tmp / "nci60.json"
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join(filter(None, [str(SRC), os.environ.get("PYTHONPATH")]))}
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.pc_run", "--dataset",
                           "NCI-60", "--json", str(out)], env=env, cwd=str(ROOT),
                          capture_output=True, text=True, timeout=600)
    secs = time.monotonic() - t0
    check(proc.returncode == 0,
          f"pc_run --dataset NCI-60 exited {proc.returncode}: {proc.stderr[-2000:]}")
    rec = json.loads(out.read_text())
    edges, levels = int(auto.adj.sum()) // 2, auto.levels_run
    print(f"phase 7 (a) python -m repro_torch.launch.pc_run --dataset NCI-60 (a subprocess, "
          f"{secs:.1f} s with its start-up): {rec['edges']} edges, {rec['levels']} levels, "
          f"total_s {rec['total_s']:.3f}; phase 3's auto: {edges} edges, {levels} levels  "
          f"[{card}]")
    for line in proc.stdout.splitlines():
        print("  | " + line)
    check((rec["edges"], rec["levels"]) == (edges, levels),
          f"pc_run NCI-60 gave {rec['edges']} edges in {rec['levels']} levels, phase 3's auto "
          f"{edges} in {levels}")

    cfg = BATCH
    b, n, m, alpha, lmax = cfg["B"], cfg["n"], cfg["m"], cfg["alpha"], cfg["max_level"]
    xs = [torch.tensor(sample_gaussian_dag(n, m, cfg["density"], seed=cfg["seed"] + k)[0],
                       dtype=torch.float32, device=dev) for k in range(b)]
    build.reset_launches()
    ops.correlation(xs[0])
    per_corr = build.LAUNCHES["corr"]
    argv = ["--batch", str(b), "--n", str(n), "--m", str(m), "--d", str(cfg["density"]),
            "--max-level", str(lmax), "--seed", str(cfg["seed"]), "--json", str(tmp / "b.json")]
    capture.clear()
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.monotonic()
    check(pc_run.main(argv) == 0, "pc_run --batch failed")
    secs = spent(torch, t0)
    got = dict(build.LAUNCHES)
    rec = json.loads((tmp / "b.json").read_text())
    cs = torch.stack([ops.correlation(x) for x in xs])
    schedule = scan_pc.plan_schedule(cs, m, alpha=alpha, max_level=lmax, device=dev)
    print(f"  pc_run {' '.join(argv[:-2])}: {secs:.3f} s in all, steady {rec['steady_s']:.4f} s "
          f"= {rec['graphs_per_s']:.1f} graphs/s, schedule {rec['schedule']} (plan_schedule on "
          f"the lanes' C: {list(schedule)}), launches {json.dumps(nonzero(got))}  [{card}]")
    check(rec["schedule"] == list(schedule),
          f"pc_run --batch planned {rec['schedule']}, plan_schedule {list(schedule)}")
    check(got["corr"] == b * per_corr and got["level0"] > 0 and got["skernel"] > 0,
          f"pc_run --batch launched {got}: not corr {per_corr} a lane, level0 and skernel")
    capture.clear()

    x_np, _ = sample_gaussian_dag(NCI60["n"], NCI60["m"], NCI60["density"], seed=NCI60["seed"])
    journal = tmp / "boot.jsonl"
    argv = ["--bootstrap", str(BOOT_REPLICATES), "--dataset", "NCI-60", "--journal",
            str(journal), "--json", str(tmp / "boot.json")]
    t0 = time.monotonic()
    check(pc_run.main(argv) == 0, "pc_run --bootstrap failed")
    secs = spent(torch, t0)
    rec = json.loads((tmp / "boot.json").read_text())
    ref = ensemble.bootstrap_pc(x_np, n_boot=BOOT_REPLICATES, seed=0, device=dev)
    phases = obs.phase_summary(obs.read_journal(str(journal)), depth=1)
    spans = {k: v for k, v in rec["timings_s"].items() if k != "total"}
    print(f"  pc_run {' '.join(argv[:4])} --journal: {secs:.3f} s with its recordings, "
          f"{rec['stable_edges']} stable edges (bootstrap_pc(x, n_boot={BOOT_REPLICATES}, "
          f"seed=0): {len(ref.stable_edges())}), spans {json.dumps(spans)}, journal "
          f"{json.dumps(phases)}, total_s {rec['total_s']:.3f}  [{card}]")
    check(rec["stable_edges"] == len(ref.stable_edges()),
          f"pc_run --bootstrap kept {rec['stable_edges']} stable edges, bootstrap_pc "
          f"{len(ref.stable_edges())}")
    check(all(phases.get(k) == v for k, v in spans.items()),
          f"the journal's phases {phases} are not the run's spans {spans}")
    check(sum(phases.values()) <= rec["total_s"], "the journal's phases outlast total_s")
    check(not obs.enabled(), "pc_run --journal left obs enabled")
    capture.clear()
    torch.cuda.empty_cache()


def serve_lines(svc, rep, n_requests, total):
    from repro_torch.launch import pc_serve

    for line in pc_serve.summary(svc, rep, n_requests, total):
        print("  | " + line)


def recordings(log):
    """What a capture log says: recordings by program name, seconds, nodes."""
    by = {}
    for name, secs, _nodes in log["recorded"]:
        by[name] = by.get(name, 0) + 1
    total = sum(secs for _, secs, _ in log["recorded"])
    worst = max((secs for _, secs, _ in log["recorded"]), default=0.0)
    return (f"{len(log['recorded'])} programs recorded {json.dumps(by)} in {total:.3f} s "
            f"(longest {worst:.3f} s), {log['evicted']} evicted (MAX_PROGRAMS)")


def serve_stream(torch, card):
    """(b) The fault-free stream through ``pc_serve``'s arrival loop on a
    MonotonicClock: every request one typed outcome, no rejection or dead
    letter, every delivered graph bitwise a solo ``pc_scan`` on its C at
    its α, corr once a request. Returns the service (for (d))."""
    import numpy as np

    from repro_torch.batch import capture, scan_pc
    from repro_torch.kernels import build, ops
    from repro_torch.launch import pc_serve

    dev = torch.device("cuda")
    args = pc_serve.parser().parse_args(list(SERVE_ARGV))
    reqs = pc_serve.stream(args)
    build.reset_launches()
    ops.correlation(torch.tensor(reqs[1][1].x, device=dev))
    per_corr = build.LAUNCHES["corr"]
    capture.clear()
    capture.reset_log()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    svc, rep, total = pc_serve.serve(pc_serve.make_service(args), reqs)
    torch.cuda.synchronize()
    got, log = dict(build.LAUNCHES), capture.log()
    peak = torch.cuda.max_memory_allocated() / 2**30
    lats = rep.latencies()
    brk = np.mean([(g.queue_wait_s, g.dispatch_s, g.assembly_s)
                   for by in rep.delivered.values() for g in by.values()], axis=0)
    print(f"phase 7 (b) PCService, pc_serve {' '.join(SERVE_ARGV)}: {len(reqs)} requests in "
          f"{total:.3f} s = {len(rep.delivered) / total:.2f} requests/s, latency p50 "
          f"{np.percentile(lats, 50):.4f} s p99 {np.percentile(lats, 99):.4f} s, mean "
          f"queue-wait {brk[0]:.4f} / dispatch {brk[1]:.4f} / assembly {brk[2]:.6f} s, "
          f"{rep.steps} dispatches; {recordings(log)}; launches {json.dumps(nonzero(got))}; "
          f"peak memory {peak:.2f} GiB  [{card}]")
    serve_lines(svc, rep, len(reqs), total)
    check(not rep.rejections and not rep.dead_letters,
          f"the fault-free stream rejected {list(rep.rejections)} or dead-lettered "
          f"{[(d.rid, d.code) for d in rep.dead_letters]}")
    for _, req in reqs:
        want = set(range(len(req.alphas or (req.alpha,))))
        check(set(rep.delivered.get(req.rid, {})) == want,
              f"{req.rid} ended with lanes {sorted(rep.delivered.get(req.rid, {}))}, not {want}")
    check(got["corr"] == per_corr * len(reqs) and got["level0"] > 0 and got["skernel"] > 0,
          f"the stream launched {got}: not corr {per_corr} a request, level0 and skernel")

    capture.reset_log()
    t0 = time.monotonic()
    for _, req in reqs:
        c = ops.correlation(torch.tensor(req.x, device=dev)).cpu().numpy()
        for lane, g in rep.delivered[req.rid].items():
            solo = scan_pc.pc_scan(c, req.x.shape[0], alpha=g.alpha, max_level=req.max_level,
                                   device=dev)
            same = all(np.array_equal(getattr(g, f), getattr(solo, f).cpu().numpy())
                       for f in ("adj", "sepsets", "cpdag"))
            check(same and g.exact and bool(solo.ok),
                  f"{req.rid} lane {lane} (tier {g.tier}) differs from its solo pc_scan")
    print(f"  every delivered graph bitwise pc_scan(c, m, alpha, max_level=3) on its own C "
          f"({spent(torch, t0):.3f} s; {recordings(capture.log())})")
    return svc


def serve_s56(torch, card, auto56, boot):
    """The paper's §5.6 instance as one request: its first call predicted
    from phase 3's per-level degrees and phase 6 (b)'s seconds a recorded
    step, run at cap 2 (cap 1 when the prediction is over
    ``SERVE_S56_FIRST_S``), bitwise the host loop's "S-kernel"."""
    import numpy as np

    from repro_torch import pc_from_corr
    from repro_torch.batch import capture, scan_pc
    from repro_torch.core import levels as L
    from repro_torch.data.synthetic_dag import sample_gaussian_dag
    from repro_torch.kernels import build, ops
    from repro_torch.serve import PCService, Request, ServeConfig

    cfg = S56
    n, m, alpha = cfg["n"], cfg["m"], cfg["alpha"]
    dev = torch.device("cuda")
    npr = {st["level"]: st["npr"] for st in auto56.level_stats}
    per_step = boot["first_s"] / boot["steps"]

    def predict(cap):
        widths = [min(L.bucket_npr(npr[ell]), n) for ell in range(1, cap + 1)]
        steps = sum(scan_pc._plan_chunk(n, w, ell, L.DEFAULT_CELL_BUDGET)[1]
                    for ell, w in enumerate(widths, 1))
        # the service records every step twice: plan_schedule's programs a
        # level, then the slot's program (each an eager run, a capture and
        # a first replay, as phase 6 (b)'s first call)
        return widths, steps, 2 * steps * per_step

    widths, steps, first = predict(2)
    cap = 2 if first <= SERVE_S56_FIRST_S else 1
    print(f"phase 7 (b) §5.6 request n={n} m={m} density {cfg['density']}: predicted first "
          f"call at cap 2 {first:.1f} s (widths {widths}, {steps} steps × 2 recordings × "
          f"{per_step * 1e3:.3f} ms, phase 6 (b)'s first call a recorded step): run at cap "
          f"{cap}" + ("" if cap == 2 else f" (predicted {predict(1)[2]:.1f} s)"))
    x = sample_gaussian_dag(n, m, cfg["density"], seed=cfg["seed"])[0].astype(np.float32)
    svc = PCService(ServeConfig())
    capture.reset_log()
    torch.cuda.synchronize()
    build.reset_launches()
    times = []
    for rid in ("s5.6", "s5.6 again"):
        t0 = time.monotonic()
        svc.submit(Request(rid=rid, x=x, alpha=alpha, max_level=cap, timeout_s=3600.0))
        rep = svc.drain()
        times.append(spent(torch, t0))
    got, log = dict(build.LAUNCHES), capture.log()
    g, again = rep.result("s5.6"), rep.result("s5.6 again")
    plan = next(e for e in rep.events if e["event"] == "plan")
    print(f"  first call {times[0]:.3f} s (latency {g.latency_s:.3f} s, dispatch "
          f"{g.dispatch_s:.3f} s), the same request again {times[1]:.3f} s; schedule "
          f"{plan['schedule']}, tier {g.tier}, {int(g.adj.sum()) // 2} edges; {recordings(log)}; "
          f"launches {json.dumps(nonzero(got))}  [{card}]")
    c = ops.correlation(torch.tensor(x, device=dev))
    ref = pc_from_corr(c, m, alpha=alpha, engine="S-kernel", max_level=cap, device=dev)
    for res in (g, again):
        check(res.tier == "slot" and res.exact
              and all(np.array_equal(getattr(res, f), getattr(ref, f))
                      for f in ("adj", "sepsets", "cpdag")),
              f"the §5.6 request (tier {res.tier}) differs from pc_from_corr(engine='S-kernel', "
              f"max_level={cap})")
    print(f"  both bitwise pc_from_corr(c, m, engine='S-kernel', max_level={cap})")
    capture.clear()
    torch.cuda.empty_cache()


def serve_faults(torch, card):
    """(c) ``pc_serve --faults`` on (b)'s stream (ManualClock): req-2
    rejected, req-4 delivered wider after one certificate miss, req-6
    retried for corruption and delivered, req-8 dead-lettered; the event
    sequence equal to the port's CPU run of the stream fed the card's C.
    Then a degrade run to the stable-ref rung, explained against the solo
    scan."""
    from repro_torch.batch import capture, scan_pc
    from repro_torch.core.cit import threshold
    from repro_torch.kernels import ops
    from repro_torch.launch import pc_serve
    from repro_torch.serve import FaultPlan, ManualClock, PCService, Request, ServeConfig
    from repro_torch.serve import admission

    dev = torch.device("cuda")
    args = pc_serve.parser().parse_args([*SERVE_ARGV, "--faults"])
    reqs = pc_serve.stream(args)
    capture.reset_log()
    t0 = time.monotonic()
    svc, rep, total = pc_serve.serve(pc_serve.make_service(args), reqs, submit_all=True)
    secs = spent(torch, t0)
    print(f"phase 7 (c) pc_serve --faults on (b)'s stream: {secs:.3f} s; "
          f"{recordings(capture.log())}  [{card}]")
    serve_lines(svc, rep, len(reqs), total)
    retries = [(e["rid"], e["reason"], e["attempt"]) for e in rep.events if e["event"] == "retry"]
    g4 = rep.delivered.get("req-4", {}).get(0)
    check(rep.rejections.get("req-2") is not None and rep.rejections["req-2"].code == "injected",
          "req-2 was not rejected as injected")
    check(g4 is not None and g4.tier == "slot-wider" and g4.attempts == 2
          and ("req-4", "cert_miss", 1) in retries,
          f"req-4 did not end at slot-wider after one certificate miss: {g4}")
    check(("req-6", "corruption", 1) in retries and "req-6" in rep.delivered,
          "req-6 was not retried for corruption and delivered")
    check([(d.rid, d.code) for d in rep.dead_letters] == [("req-8", "deadline")],
          f"the dead letters are {[(d.rid, d.code) for d in rep.dead_letters]}, not req-8's "
          "deadline")

    keys = ("event", "rid", "rids", "lane", "attempt", "attempts", "schedule", "jitter")

    def events(r):
        return [{k: (list(e[k]) if isinstance(e[k], tuple) else e[k]) for k in keys if k in e}
                for e in r.events]

    cpu_args = pc_serve.parser().parse_args([*SERVE_ARGV, "--faults", "--device", "cpu"])
    own = admission.sample_correlation
    admission.sample_correlation = lambda x, device: own(x, dev)  # the card's C
    try:
        t0 = time.monotonic()
        _, cpu_rep, _ = pc_serve.serve(pc_serve.make_service(cpu_args), pc_serve.stream(cpu_args),
                                       submit_all=True)
        cpu_s = time.monotonic() - t0
    finally:
        admission.sample_correlation = own
    same = events(rep) == events(cpu_rep)
    print(f"  the CPU run of the same stream on the card's C ({cpu_s:.1f} s): {len(rep.events)} "
          f"events, sequence equal {same}")
    check(same, "the card's event sequence differs from the CPU run's")

    cfg = ServeConfig()
    rid, req = reqs[0][1].rid, reqs[0][1]
    m = req.x.shape[0]
    svc_d = PCService(cfg, clock=ManualClock(),
                      faults=FaultPlan(cert_miss={rid: cfg.widen_attempts + 2}))
    svc_d.submit(Request(rid=rid, x=req.x, alpha=req.alpha, max_level=req.max_level))
    t0 = time.monotonic()
    g = svc_d.drain().result(rid)
    secs = spent(torch, t0)
    c = ops.correlation(torch.tensor(req.x, device=dev))
    solo = scan_pc.pc_scan(c, m, alpha=req.alpha, max_level=req.max_level, device=dev)
    solo = SimpleNamespace(adj=solo.adj.cpu().numpy(), sepsets=solo.sepsets.cpu().numpy())
    n_diff, unexplained = explain_diffs(g, solo, c.double().cpu().numpy(), m, req.alpha,
                                        threshold, sepsets=False, empty=True)
    print(f"  degrade run, {rid} (n={req.x.shape[1]}) with cert_miss {cfg.widen_attempts + 2}: "
          f"tier {g.tier}, exact {g.exact}, {g.attempts} attempts, {secs:.3f} s; against its "
          f"solo pc_scan {n_diff} edges differ ({unexplained} outside the τ band and fp32 "
          f"bound), {int(g.adj.sum()) // 2} edges")
    check(g.tier == "stable-ref" and not g.exact, f"the degrade run ended at {g.tier}")
    check(unexplained == 0, "the stable-ref skeleton differs from the solo scan outside the band")
    capture.clear()


def serve_scrape(svc):
    """(d) ``pc_serve``'s metrics endpoint on (b)'s service: a GET of
    /metrics on a free localhost port."""
    import socket
    import urllib.request

    from repro_torch.launch import pc_serve

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    httpd = pc_serve.serve_metrics(svc, port)
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as resp:
            body = resp.read().decode()
    finally:
        httpd.shutdown()
        httpd.server_close()
    names = ("pc_serve_deliveries_total", "pc_serve_requests_total",
             "pc_serve_latency_seconds_count")
    lines = [ln for ln in body.splitlines() if ln.startswith(names)]
    print(f"phase 7 (d) GET http://127.0.0.1:{port}/metrics: {len(body)} bytes; "
          + "; ".join(lines))
    check(any(ln.startswith("pc_serve_deliveries_total") for ln in lines),
          "the /metrics scrape has no pc_serve_deliveries_total")


# phase 8: the multi-device layer. A mesh of MESH_SHARDS logical shards on
# the one card, or every visible card when there are more than one
MESH_SHARDS = 4
# pc_distributed's layouts, each under "S" and "S-grid" (speculation is the
# grid engine's), and "S" at pipeline depth 2
MESH_LAYOUTS = (("replicated", {}), ("shard_c", dict(shard_c=True)),
                ("shard_sep", dict(shard_sep=True)),
                ("shard_c+shard_sep+speculate", dict(shard_c=True, shard_sep=True,
                                                     speculate=True)))
# phase 8's bootstrap: lane 0 of the batch cell (a), replicates not a
# multiple of the shards (identity-lane pad)
MESH_BOOT_REPLICATES = 18


def multi_device(torch, card, svc):
    """Phase 8: ``pc_distributed`` on NCI-60 and §5.6 in every layout,
    bitwise the port's single-device run; ``ops.chunk_s_grid_tests_cols``
    (sgrid's sharded-C route) at NCI-60's first ℓ = 1 launch and §5.6's
    first ℓ = 2 launch; ``pc_scan_batch`` and ``bootstrap_pc`` at the batch
    cell (a) and the serving stream of phase 7 (``svc``, its unsharded
    service) with ``mesh=``, each bitwise its unsharded run."""
    from repro_torch.core import sharding as S

    t_phase = time.monotonic()
    n_cards = torch.cuda.device_count()
    mesh = (S.make_mesh() if n_cards > 1
            else S.make_mesh(devices=("cuda:0",) * MESH_SHARDS))
    kind = "every visible card" if n_cards > 1 else "logical shards on one card"
    print(f"phase 8 mesh: {mesh!r} ({kind})  [{card}]")
    for label, cfg in (("NCI-60", NCI60), ("§5.6", S56)):
        mesh_runs(torch, card, label, cfg, mesh)
    mesh_batch(torch, card, mesh)
    mesh_serving(torch, card, mesh, svc)
    print(f"phase 8: {time.monotonic() - t_phase:.1f} s  [{card}]")


def mesh_runs(torch, card, label, cfg, mesh):
    """``pc_distributed`` on one instance in each layout of MESH_LAYOUTS
    under "S" and "S-grid" and "S" at depth 2, with the counts reset just
    before each and read just after: adj, sepsets and CPDAG bitwise the
    single-device ``pc(x, engine=e)`` on the card; the per-level chunks,
    dispatches and column-gather bytes and a steady call's seconds. Then
    the sharded-C route on the instance's first grid launch."""
    import numpy as np

    from repro_torch import pc
    from repro_torch.core import engines
    from repro_torch.core.cit import threshold
    from repro_torch.core.distributed import pc_distributed
    from repro_torch.data.synthetic_dag import sample_gaussian_dag
    from repro_torch.kernels import build, ops

    dev = mesh[0]
    k = len(mesh)
    n, m, alpha = cfg["n"], cfg["m"], cfg["alpha"]
    x_np, _ = sample_gaussian_dag(n, m, cfg["density"], seed=cfg["seed"])
    singles = {e: pc(x_np, alpha=alpha, engine=e, device=dev) for e in ("S", "S-grid")}
    if label == "NCI-60":
        # what sharding relies on: on the card "S" decides a test the same
        # in a chunk of any shape (levels._sweep_terms_in_order)
        small = pc(x_np, alpha=alpha, engine="S", device=dev, cell_budget=2**20)
        same = all(np.array_equal(getattr(small, f), getattr(singles["S"], f))
                   for f in ("adj", "sepsets", "cpdag"))
        print(f"phase 8 {label} single-device S at cell_budget 2^20 "
              f"({sum(st['chunks'] for st in small.level_stats)} chunks, default "
              f"{sum(st['chunks'] for st in singles['S'].level_stats)}): bitwise the default "
              f"budget's {same}  [{card}]")
        check(same, f"{label} S depends on its chunk plan on the card")
    runs = [(e, name, kw) for e in ("S", "S-grid") for name, kw in MESH_LAYOUTS]
    runs = [(e, name, {key: v for key, v in kw.items() if e == "S-grid" or key != "speculate"})
            for e, name, kw in runs] + [("S", "replicated, depth 2", dict(pipeline_depth=2))]
    for engine, name, kw in runs:
        name = name.replace("+speculate", "") if "speculate" not in kw else name
        def call(engine=engine, kw=kw):
            return pc_distributed(x_np, alpha=alpha, mesh=mesh, engine=engine, **kw)

        for d in mesh.distinct():
            torch.cuda.synchronize(d)
        build.reset_launches()
        t0 = time.monotonic()
        run = call()
        first_s = time.monotonic() - t0
        got = dict(build.LAUNCHES)
        t0 = time.monotonic()
        again = call()
        steady_s = time.monotonic() - t0
        want = singles[engine]
        same = all(np.array_equal(getattr(run, f), getattr(want, f))
                   for f in ("adj", "sepsets", "cpdag"))
        chunks = sum(st["chunks"] for st in run.level_stats)
        print(f"phase 8 pc_distributed {label} engine={engine} {name} on {k} shards: first "
              f"{first_s:.3f} s, steady {steady_s:.3f} s, {run.levels_run} levels, "
              f"{int(run.adj.sum()) // 2} edges, bitwise single-device pc(x, engine={engine!r}): "
              f"{same}; launches {json.dumps(nonzero(got))}  [{card}]")
        for st in run.level_stats:
            print(f"  level {st['level']}: chunks {st['chunks']} dispatches {st['dispatches']} "
                  f"n_chunk {st.get('n_chunk')} npr_bucket {st.get('npr_bucket')} "
                  f"col_gathers {st.get('col_gathers', '-')} col_gather_bytes "
                  f"{st.get('col_gather_bytes', '-')} speculative {st.get('speculative', False)}")
        check(same, f"pc_distributed {label} {engine} {name} differs from the single-device run")
        check(all(np.array_equal(getattr(again, f), getattr(run, f))
                  for f in ("adj", "sepsets", "cpdag")), f"two {label} {name} calls disagree")
        check(got["corr"] > 0 and got["level0"] == 1,
              f"{label} {engine} {name}: corr or level0 (once) did not launch: {got}")
        if engine == "S-grid":
            # one sgrid launch a shard a planned launch; a speculative
            # launch for the level where the run stops is dropped
            extra = k if kw.get("speculate") else 0
            check(k * chunks <= got["sgrid"] <= k * chunks + extra,
                  f"{label} S-grid {name}: sgrid launched {got['sgrid']} times for {chunks} "
                  f"launches on {k} shards")
        else:
            check(not any(got[key] for key in ("sgrid", "skernel", "cholinv", "cisweep")),
                  f"{label} S {name} launched a kernel of another engine: {got}")
    # the single-device runs' mutual agreement (the sharded ones equal them)
    c64 = ops.correlation(torch.tensor(x_np, dtype=torch.float32, device=dev)).double().cpu()
    n_diff, unexplained = explain_diffs(singles["S-grid"], singles["S"], c64.numpy(), m, alpha,
                                        threshold)
    print(f"  single-device S-grid against S: {n_diff} edges differ ({unexplained} outside the "
          "τ band and fp32 bound)")
    check(unexplained == 0, f"{label}: S-grid differs from S outside the τ band")

    c = ops.correlation(torch.tensor(x_np, dtype=torch.float32, device=dev))
    tau = [threshold(m, ell, alpha) for ell in range(3)]
    adj, sep0, _ = ops.level0_span(c, tau[0], 8)
    ell = 1 if label == "NCI-60" else 2
    if ell == 2:
        adj, _, _ = engines.run_level(c, adj, sep0, 1, tau[1])
    sharded_c_route(torch, card, label, c, adj, ell, tau[ell], mesh)


def sharded_c_route(torch, card, label, c, adj, ell, tau, mesh):
    """``ops.chunk_s_grid_tests_cols`` on every shard's first launch of
    level ℓ as ``pc_distributed(shard_c=True, engine="S-grid")`` plans it:
    ``levels.gather_s_cols`` over the shard's rows of C and the gathered
    active columns, then sgrid's gathered entry. Each shard's winners are
    held to the plain version (``sgrid_plain`` on the same gather) within
    the τ band and to the fused entry on the same launch bitwise; shard
    0's launch is timed (the route, its gather, the kernel alone, the
    fused route, the plain version), the kernel's bound counted as the
    gathered rows of phase 2 count it (``sgrid_work``)."""
    from repro_torch.core import distributed as DI, levels as L, sharding as S
    from repro_torch.kernels import build, ops, sgrid

    n, k = c.shape[0], len(mesh)
    pad = S.pad_amount(n, mesh)
    npr = int(adj.sum(1).max())
    npr_b, n_chunk, total = L.plan_level(npr, ell, max((n + pad) // k, 1),
                                         cell_budget=L.GRID_CELL_BUDGET, n_cols=n)
    adj_rep = S.replicate(adj, mesh)
    lv = DI._Level(adj_rep, mesh, npr_b)
    c_rows = DI.shard_correlation(c, mesh)
    cols, col_pos, k_cols = DI._active_columns(adj.sum(1, dtype=torch.int32).cpu().numpy(), n)
    c_cols = DI._gather_cols(c_rows, mesh, cols)
    pos = S.replicate(torch.from_numpy(col_pos), mesh)
    c_t = c.T.contiguous()
    kw = dict(ell=ell, n_chunk=n_chunk, n_max=npr_b)
    build.reset_launches()
    checked = []
    for s in range(k):
        dev = mesh[s]
        t0 = torch.zeros((), dtype=torch.int32, device=dev)
        args = (c_rows[s], c_cols[s], pos[s], adj_rep[s], lv.compact[s], lv.counts[s], lv.rows[s])
        g = L.gather_s_cols(*args, L._chunk_ranks(t0, n_chunk), ell=ell, n_max=npr_b)
        got = ops.ci_shared_grid(*g, tau, ell=ell)
        fused = sgrid.sgrid_fused(c.to(dev), adj_rep[s], lv.compact[s], lv.counts[s],
                                  lv.rows[s], t0, tau, c_t=c_t.to(dev), **kw)
        t_p, n_diff, n_out, n_band, _ = winners_check(
            torch, f"sharded-C route {label} shard {s}", got,
            lambda d, g=g: sgrid.sgrid_plain(*g, tau + d))
        check(torch.equal(got[0], fused[0]) and torch.equal(got[1], fused[1]),
              f"sharded-C route {label} shard {s}: winners differ from the fused entry's")
        checked.append((n_diff, n_out, n_band))
        if s == 0:
            first = (args, g, t0, t_p)
    launches = build.LAUNCHES["sgrid"]
    args, g, t0, t_p = first
    route_ms = cuda_ms(torch, lambda: ops.chunk_s_grid_tests_cols(*args, t0, tau, **kw))
    gather_ms = cuda_ms(torch, lambda: L.gather_s_cols(*args, L._chunk_ranks(t0, n_chunk),
                                                       ell=ell, n_max=npr_b))
    k_ms = cuda_ms(torch, lambda: ops.ci_shared_grid(*g, tau, ell=ell))
    fused_ms = cuda_ms(torch, lambda: ops.chunk_s_grid_tests(c, adj, lv.compact[0], lv.counts[0],
                                                             lv.rows[0], t0, tau, c_t=c_t, **kw))
    p_ms = cuda_ms(torch, lambda: sgrid.sgrid_plain(*g, tau), reps=3, warmup=1)
    mask = g[4]
    n_l, _, npr_g = mask.shape
    cells, tested, ranks, found = sgrid_work(torch, t_p, mask)
    bytes_moved = (ranks * (ell * ell + ell) * 4 + cells + tested * 4 * ell + n_l * npr_g * 4
                   + found * ell * 4 + n_l * npr_g * (ell + 1) * 4)
    b_ms, b_by = bound(bytes_moved, ranks * cholinv_ops(ell) + tested * cisweep_ops(ell))
    print(f"phase 8 sharded-C route ops.chunk_s_grid_tests_cols {label} first ℓ={ell} launch: "
          f"{k} shards of n_l={n_l}, T={n_chunk} of {total} ranks, n′={npr_b}, k={k_cols} "
          f"gathered columns; winners (differing, outside the τ band, band cells) per shard "
          f"{checked}, bitwise the fused entry on every shard; sgrid launched {launches} times "
          f"({k} shards, each once a launch: 2 a shard here, the route and its check's fused "
          f"entry); shard 0: route {route_ms:.4f} ms (gather_s_cols {gather_ms:.4f}, the "
          f"gathered kernel {k_ms:.4f}), fused route on the same launch {fused_ms:.4f} ms, "
          f"plain {p_ms:.4f} ms, kernel bound {b_ms:.5f} ms ({b_by}: {tested} tested of {cells} "
          f"visited cells, {ranks} set inverses)  [{card}]")
    check(launches == 2 * k, f"sgrid launched {launches} times, not twice on each of {k} shards")


def mesh_batch(torch, card, mesh):
    """``pc_scan_batch`` on the batch cell (a) and ``bootstrap_pc`` on its
    lane 0 (MESH_BOOT_REPLICATES replicates: identity-lane pad) with
    ``mesh=``, each bitwise its ``mesh=None`` run; each shard records its
    own program."""
    import numpy as np

    from repro_torch.batch import capture, ensemble, scan_pc
    from repro_torch.data.synthetic_dag import sample_gaussian_dag
    from repro_torch.kernels import build, ops

    cfg = BATCH
    b, n, m, alpha, lmax = cfg["B"], cfg["n"], cfg["m"], cfg["alpha"], cfg["max_level"]
    dev = mesh[0]
    xs = [sample_gaussian_dag(n, m, cfg["density"], seed=cfg["seed"] + j)[0] for j in range(b)]
    cs = torch.stack([ops.correlation(torch.tensor(x, dtype=torch.float32, device=dev))
                      for x in xs])
    capture.clear()
    schedule = scan_pc.plan_schedule(cs, m, alpha=alpha, max_level=lmax, bucket=False,
                                     device=dev)
    kw = dict(alpha=alpha, max_level=lmax, n_prime=schedule, orient=False)
    one = scan_pc.pc_scan_batch(cs, m, device=dev, **kw)
    t0 = time.monotonic()
    first = scan_pc.pc_scan_batch(cs, m, mesh=mesh, **kw)
    first_s = spent(torch, t0)
    build.reset_launches()
    t0 = time.monotonic()
    sharded = scan_pc.pc_scan_batch(cs, m, mesh=mesh, **kw)
    steady_s = spent(torch, t0)
    got = dict(build.LAUNCHES)
    same = all(torch.equal(getattr(sharded, f), getattr(one, f)) for f in one._fields)
    print(f"phase 8 pc_scan_batch batch cell (a) B={b} on {len(mesh)} shards: schedule "
          f"{schedule}, first {first_s:.3f} s (a program a shard), steady {steady_s:.4f} s, "
          f"bitwise mesh=None {same}; launches {json.dumps(nonzero(got))}  [{card}]")
    check(same and all(torch.equal(getattr(first, f), getattr(one, f)) for f in one._fields),
          "sharded pc_scan_batch differs from mesh=None")
    check(got["level0"] == b and got["skernel"] > 0, f"sharded replay launches {got}")

    nb = MESH_BOOT_REPLICATES
    x = torch.tensor(xs[0], dtype=torch.float32, device=dev)
    boot = dict(n_boot=nb, alpha=alpha, max_level=lmax, seed=0)
    t0 = time.monotonic()
    ref = ensemble.bootstrap_pc(x, device=dev, **boot)
    ref_s = spent(torch, t0)
    t0 = time.monotonic()
    got_boot = ensemble.bootstrap_pc(x, mesh=mesh, **boot)
    boot_s = spent(torch, t0)
    same = all(np.array_equal(getattr(got_boot, f), getattr(ref, f))
               for f in ("edge_freq", "adj", "cpdag", "replicate_adj", "replicate_ok"))
    print(f"phase 8 bootstrap_pc lane 0 of (a), {nb} replicates on {len(mesh)} shards "
          f"(pad {(-nb) % len(mesh)}): {boot_s:.3f} s (mesh=None {ref_s:.3f} s, both with "
          f"recordings), schedule {got_boot.schedule}, bitwise mesh=None {same}  [{card}]")
    check(same and got_boot.schedule == ref.schedule,
          "sharded bootstrap_pc differs from mesh=None")
    capture.clear()


def mesh_serving(torch, card, mesh, svc):
    """Phase 7 (b)'s stream through ``PCService(ServeConfig(mesh=))``: the
    same outcomes, every delivered graph bitwise the unsharded service's
    (``svc``) for the same request and lane."""
    import numpy as np

    from repro_torch.batch import capture
    from repro_torch.launch import pc_serve
    from repro_torch.serve import PCService, ServeConfig

    args = pc_serve.parser().parse_args(list(SERVE_ARGV))
    reqs = pc_serve.stream(args)
    capture.clear()
    capture.reset_log()
    sharded = PCService(ServeConfig(slot_size=args.slot_size, mesh=mesh))
    sharded, rep, total = pc_serve.serve(sharded, reqs)
    torch.cuda.synchronize()
    plain = svc.report
    print(f"phase 8 PCService(ServeConfig(mesh=)) on phase 7 (b)'s stream, {len(mesh)} shards: "
          f"{len(reqs)} requests in {total:.3f} s = {len(rep.delivered) / total:.2f} requests/s, "
          f"{rep.steps} dispatches; {recordings(capture.log())}  [{card}]")
    check(not rep.rejections and not rep.dead_letters,
          "the sharded stream rejected or dead-lettered a request")
    check({r: sorted(v) for r, v in rep.delivered.items()}
          == {r: sorted(v) for r, v in plain.delivered.items()},
          "the sharded stream delivered other lanes than the unsharded one")
    for rid, lanes in plain.delivered.items():
        for lane, want in lanes.items():
            g = rep.delivered[rid][lane]
            check(all(np.array_equal(getattr(g, f), getattr(want, f))
                      for f in ("adj", "sepsets", "cpdag")) and g.exact,
                  f"{rid} lane {lane}: the sharded service's graph differs from the unsharded")
    print("  every delivered graph bitwise the unsharded service's")
    capture.clear()


def contracts(torch, card):
    """Phase 9: the port's contract suite (``repro_torch.analysis``) on the
    card, layers 1–3, gated on ``analysis_baseline_torch.json``."""
    from repro_torch.analysis import BASELINE_NAME, compare, load_baseline, run_all
    from repro_torch.batch import capture

    capture.clear()
    t_phase = time.monotonic()
    rep = run_all(str(ROOT), layers=(1, 2, 3), device="cuda")
    secs = time.monotonic() - t_phase
    new, stale, accepted = compare(rep.sorted(), load_baseline(ROOT / BASELINE_NAME))
    for f in rep.sorted():
        print("  " + f.format())
    print(f"phase 9 repro_torch.analysis layers 1,2,3: {len(rep.findings)} findings, "
          f"{len(new)} outside the baseline, {len(stale)} stale entries, {len(accepted)} "
          "baselined")
    for line in rep.advisories:
        print("  " + line)
    for row in rep.tables["entries"]:
        print(f"phase 9 entry {row['name']}: hand kernels {row['kernels']} (declared "
              f"{row['declared']}, reference {row['reference']}) "
              f"{json.dumps(nonzero(row['launches']))}; sync-debug warnings "
              f"{row['all_syncs']}: {row['seam_syncs']} in allowlisted seams, {row['syncs']} "
              f"outside; float64 ops {row['f64_ops']}")
    for row in rep.tables["contract"]:
        print(f"phase 9 {row['name']}: chunks {row['chunks']}, dispatches {row['dispatches']}; "
              f"sync-debug warnings {row['seam_syncs']} in allowlisted seams, {row['syncs']} "
              "outside")
    for row in rep.tables["kernels"]:
        print(f"phase 9 RPR201/202 {row['name']} ({row['kernel']}): poison reached the outputs "
              f"{row['poison_landed']}, 0xFF and 0x00 runs bitwise {row['poison_equal']}, plain "
              f"version ({row['compare']}) {row['plain']}, two launches bitwise "
              f"{row['repeat_equal']}")
    print(f"phase 9 RPR203 ptxas -v per entry function  [{card}]:")
    for row in rep.tables["resources"]:
        print(f"  {row['kernel']:8s} {row['function']:26s} {row['registers']:4d} registers × "
              f"{row['threads']:3d} threads = {row['block_registers']:6d}, stack {row['stack']} B, "
              f"spills {row['spill_stores']}/{row['spill_loads']} B, smem {row['static_smem']} B "
              f"static + {row['dyn_smem']} dynamic (limit {row['smem_limit']} B), "
              f"{row['launcher']}")
    print(f"phase 9: {secs:.1f} s  [{card}]")
    check(not new and not stale, f"phase 9: {len(new)} findings outside the baseline, "
          f"{len(stale)} stale baseline entries")
    check(all(r["kernels"] == r["declared"] and r["syncs"] == 0 for r in rep.tables["entries"]),
          "phase 9: an entry's hand-kernel count or sync warnings break the contract")
    check(all(r["syncs"] == 0 for r in rep.tables["contract"]),
          "phase 9: a pc_from_corr run synced outside the allowlisted seams")
    check(all(r["poison_landed"] and r["poison_equal"] and r["plain"] and r["repeat_equal"]
              for r in rep.tables["kernels"]), "phase 9: RPR201/RPR202 failed")
    check(len({r["kernel"] for r in rep.tables["kernels"]}) == 8
          and {r["kernel"] for r in rep.tables["resources"]} >= {r["kernel"] for r in
                                                               rep.tables["kernels"]},
          "phase 9: not every kernel was checked")
    capture.clear()


# ---------------------------------------------------------------------------
# phase 10: the LM serving path at full width
LM_ARCH = "qwen3-1.7b"
LM_SHAPE = dict(batch=4, prompt_len=32, gen=16)  # launch.serve's defaults: bf16 compute
LM_DEPTH = 2  # (c), (h): the full width cut to this many layers
LM_STEPS = 4
LM_OTHERS = ("qwen2-1.5b", "stablelm-3b", "starcoder2-15b", "paligemma-3b")
MOE_ARCH = "qwen2-moe-a2.7b"  # (e): 24 layers, 60 routed + 4 shared experts padded to 64
SSM_ARCHS = ("rwkv6-3b", "zamba2-1.2b")  # (f)
MLA_ARCH, MLA_DEPTH = "deepseek-v2-236b", 3  # (g): 1 mla_mlp + 2 mla_moe layers
# (f): rwkv6-3b's random 32-layer model moves its logits by ~3.5e-2 when its
# embeddings move by 1e-7 of themselves (fp32 rounding's size), so no two
# sum orders agree to 2e-2 at full depth; at this depth the reference's
# 2e-2 holds as it is
RWKV_HELD_DEPTH = 8
# (b), (e)-(g): a prefill/decode difference is held to the larger of the
# reference's 2e-2 and this many times the model's response to a 1e-7
# relative change of its embeddings
CHAOS_MARGIN = 4
ORACLE_T = 100  # (i): not a whole number of chunks (64 for Mamba2, 32 for RWKV6)


def lm_serving(torch, card):
    """Phase 10: ``repro_torch.launch.serve`` and the models it drives, with
    the launch counts reset just before and read just after (the path has
    no hand kernel: every count stays 0)."""
    from repro_torch.kernels import build

    t_phase = time.monotonic()
    build.reset_launches()
    serve_calls(torch, card, "(a)", LM_ARCH, ("first", "again"))
    lm_decode_profile(torch, card, "(a)", LM_ARCH)
    lm_consistency(torch, card, "(b)", LM_ARCH)
    lm_card_vs_cpu(torch, card, f"(c) {LM_ARCH} full width cut to {LM_DEPTH} layers", LM_ARCH,
                   LM_DEPTH)
    for arch in LM_OTHERS:
        lm_card_vs_cpu(torch, card, f"(d) {arch} reduced", arch, None)
    # every other decoder segment kind: MoE, MLA, Mamba2, RWKV6, zamba2's sites
    serve_calls(torch, card, "(e)", MOE_ARCH, ("first", "again"))
    lm_decode_profile(torch, card, "(e)", MOE_ARCH)
    lm_consistency(torch, card, "(e)", MOE_ARCH)
    for arch in SSM_ARCHS:
        serve_calls(torch, card, "(f)", arch, ("first",))
        lm_consistency(torch, card, "(f)", arch)
    lm_consistency(torch, card, "(f)", "rwkv6-3b", depth=RWKV_HELD_DEPTH)
    lm_consistency(torch, card, "(g)", MLA_ARCH, depth=MLA_DEPTH)
    lm_card_vs_cpu(torch, card, f"(h) {MOE_ARCH} full width cut to {LM_DEPTH} layers",
                   MOE_ARCH, LM_DEPTH)
    lm_card_vs_cpu(torch, card, f"(h) rwkv6-3b full width cut to {LM_DEPTH} layers",
                   "rwkv6-3b", LM_DEPTH)
    from repro_torch.configs import ARCHS

    lm_card_vs_cpu(torch, card, "(h) zamba2-1.2b full width and depth", "zamba2-1.2b",
                   ARCHS["zamba2-1.2b"].n_layers)
    lm_card_vs_cpu(torch, card, f"(h) {MLA_ARCH} reduced", MLA_ARCH, None)
    mixer_oracles(torch, card)
    moe_repeatable(torch, card)
    got = nonzero(dict(build.LAUNCHES))
    print(f"phase 10: {time.monotonic() - t_phase:.1f} s, hand-kernel launches {json.dumps(got)}"
          f"  [{card}]")
    check(not got, f"phase 10: the LM path launched hand kernels {got}")
    torch.cuda.empty_cache()


def serve_calls(torch, card, tag, arch, runs):
    """``serve.main(["--arch", arch])`` at full width (batch 4, prompt 32,
    16 generated tokens, bf16 compute, fp32 parameters), once a run name,
    with its four lines and peak memory."""
    import contextlib
    import io

    from repro_torch.launch import serve

    argv = ["--arch", arch]
    for run in runs:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = serve.main(argv)
        check(rc == 0, f"launch.serve {' '.join(argv)} exited {rc}")
        lines = out.getvalue().strip().splitlines()
        check(len(lines) == 4 and lines[0] == f"[serve] {arch}", f"launch.serve printed {lines}")
        print(f"phase 10 {tag} python -m repro_torch.launch.serve {' '.join(argv)} ({run} call, "
              f"full width, bf16 compute, fp32 parameters): peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  [{card}]")
        for line in lines:
            print("  " + line.strip())
    torch.cuda.empty_cache()


class MoERecorder:
    """Wraps ``transformer.moe_apply`` while active: each MoE call's
    selections (N, k) and the assignments its capacity dropped (a device
    scalar), from ``moe.route`` and ``moe.capacity`` on the call's input.
    Given ``pinned``, a list of (N, k) selections one a call, the i-th
    call routes its tokens to ``pinned[i]`` (gates: those experts'
    probabilities, renormalised as ``route`` does) instead of its top k."""

    def __init__(self, torch, pinned=None):
        self.torch, self.calls, self.pinned = torch, [], pinned

    def __enter__(self):
        from repro_torch.models import moe
        from repro_torch.models import transformer as TT

        self.real = TT.moe_apply

        def recorded(p, cfg, x):
            xf = x.reshape(-1, x.shape[-1])
            _, _, sel = moe.route(p, cfg, xf)
            counts = self.torch.zeros(cfg.moe.padded, dtype=self.torch.int64, device=x.device)
            counts.scatter_add_(0, sel.reshape(-1), self.torch.ones_like(sel.reshape(-1)))
            dropped = (counts - moe.capacity(cfg, xf.shape[0])).clamp(min=0).sum()
            self.calls.append((sel, dropped))
            if self.pinned is None:
                return self.real(p, cfg, x)
            want, route = self.pinned[len(self.calls) - 1], moe.route

            def pinned_route(p_, cfg_, xf_):
                probs, _, _ = route(p_, cfg_, xf_)
                gates = probs.gather(-1, want)
                if cfg_.moe.norm_topk:
                    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
                return probs, gates, want

            moe.route = pinned_route
            try:
                return self.real(p, cfg, x)
            finally:
                moe.route = route

        TT.moe_apply = recorded
        return self

    def __exit__(self, *exc):
        from repro_torch.models import transformer as TT

        TT.moe_apply = self.real


def traced(torch, fn, reps=10, warm=True):
    """``fn`` steady on the host clock (a warm call, then ``reps`` calls, to
    the card's idle) and one call traced by ``torch.profiler``: the
    kernels' summed device time, their count, the busiest by name and the
    idle share of the steady call. Returns the numbers and their line."""
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(reps):
        fn()
    step_ms = spent(torch, t0) / reps * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # device-side events only: a CPU op's row repeats its kernels' time
    busy = sorted((e for e in prof.key_averages() if e.self_device_time_total > 0
                   and str(e.device_type).endswith("CUDA")),
                  key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in busy) / 1e3
    top = "; ".join(f"{e.key[:48]} ×{e.count} {e.self_device_time_total / 1e3:.3f} ms"
                    for e in busy[:4])
    idle = f"{1 - busy_ms / step_ms:.3f}" if busy else "not measured (no device events)"
    text = (f"steady {step_ms:.3f} ms a call, kernels busy {busy_ms:.3f} ms "
            f"({sum(e.count for e in busy)} device events), idle share {idle}; busiest: {top}")
    return dict(ms=step_ms, busy_ms=busy_ms, text=text)


def lm_decode_profile(torch, card, tag, arch):
    """``arch`` at full width as ``launch.serve`` runs it (its prompts): the
    steady prefill and decode step on the host clock (to the card's idle),
    one of each traced by ``torch.profiler`` (the kernels' summed device
    time, their count, the busiest by name), and the least time a decode
    step could take: it reads the fp32 parameters once (each is cast to
    bf16 at its use; the MoE layers cast every expert). An MoE model's
    prefill is run once more with its capacity drops counted."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch import serve
    from repro_torch.models import moe, registry

    cfg = ARCHS[arch]
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    api = registry.build(cfg, compute_dtype=torch.bfloat16, device=dev)
    params = api.init()
    n_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    batch = serve.prompts(cfg, LM_SHAPE["batch"], LM_SHAPE["prompt_len"], dev)
    t_max = LM_SHAPE["prompt_len"] + LM_SHAPE["gen"] + (cfg.vis_ctx or 0)
    logits, cache = api.prefill(params, batch, t_max)
    tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
    calls = {"prefill": lambda: api.prefill(params, batch, t_max),
             # rewrites the cache's slot `len` each call: the same step again
             "decode step": lambda: api.decode(params, {"tokens": tok}, cache)}
    for name, fn in calls.items():
        shape = (f"prompt {LM_SHAPE['prompt_len']}" if name == "prefill"
                 else f"cache of {t_max}")
        print(f"phase 10 {tag} {arch} {name}, bf16 compute, batch {LM_SHAPE['batch']}, "
              f"{shape}: {traced(torch, fn)['text']}  [{card}]")
    print(f"phase 10 {tag} {arch}: a decode step reads the {n_bytes / 1e9:.3f} GB of fp32 "
          f"parameters: at least {n_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms at 3.35 TB/s (bytes)"
          f"  [{card}]")
    if cfg.moe:
        with MoERecorder(torch) as rec:
            api.prefill(params, batch, t_max)
        dropped = [int(d) for _, d in rec.calls]
        n = LM_SHAPE["batch"] * LM_SHAPE["prompt_len"]
        print(f"phase 10 {tag} {arch} prefill of {n} tokens: capacity {moe.capacity(cfg, n)} "
              f"slots an expert, {sum(dropped)} of {len(dropped) * n * cfg.moe.top_k} "
              f"assignments dropped (by layer {dropped})  [{card}]")
    del params, cache
    torch.cuda.empty_cache()


def lm_consistency(torch, card, tag, arch, depth=None):
    """The full-width model (cut to ``depth`` layers where given) in fp32
    compute (TF32 off), MoE at capacity factor 8 as the reference's check
    runs it (tests/test_models.py:64-87): finite logits, every cache tensor
    on the card, and one decode step after a prefill of T against the
    prefill of T + 1, through an fp32 cache and through the serving
    default, a bf16 one.

    The fp32 cache is held to the reference's 2e-2, or CHAOS_MARGIN times
    the model's own sensitivity where that is larger: the prefill of T + 1
    again with its embeddings scaled by 1 + 1e-7·N(0, 1), fp32 rounding's
    size. The bf16 cache rounds what the prefill stored (k/v, MLA's
    ckv/kpe, the Mamba2 conv window: ``transformer.py:423-425``, as the
    reference does), and its decode rounds the new token's entries and
    GQA's attention weights to the same bf16 (``attention.py:62-64``).
    What the stored values' rounding alone moves, the fp32 decode step
    from the bf16 cache's values, is measured; where twice that (once for
    the stored values, once for the decode's own roundings of the same
    size) is larger than the fp32 cache's bound, it is the bf16 cache's
    bound. Top-k
    routing is not continuous: the bf16 cache moves the decoded token's
    hidden state by ~1e-3 of itself, which can change a token's experts
    where two router probabilities are that close. So an MoE model's
    decode steps are recorded (``MoERecorder``) and its selections
    compared with the prefill's at the last position; the bound is held on
    the batch rows whose selections all agree, and on every row by decode
    steps whose routing is pinned to the prefill's selections."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.launch import serve
    from repro_torch.models import registry, transformer as TT

    cfg = ARCHS[arch]
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    if cfg.moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    api = registry.build(cfg, compute_dtype=torch.float32, device=dev)
    params = api.init()
    n_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    batch = serve.prompts(cfg, LM_SHAPE["batch"], LM_SHAPE["prompt_len"], dev)
    t = LM_SHAPE["prompt_len"] + (cfg.vis_ctx or 0)
    t_max = t + LM_SHAPE["gen"]
    last = torch.arange(LM_SHAPE["batch"], device=dev) * (t + 1) + t
    cut = f"cut to {depth} layers" if depth is not None else f"{cfg.n_layers} layers"
    print(f"phase 10 {tag} {arch} full width ({cut}, d_model {cfg.d_model}, vocab {cfg.vocab} "
          f"padded {cfg.padded_vocab}), fp32 compute, TF32 off"
          f"{', MoE capacity factor 8' if cfg.moe else ''}: {n_bytes / 1e9:.3f} GB of "
          f"parameters (reading them once takes {n_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms at "
          f"3.35 TB/s)  [{card}]")

    def row_err(dec):  # (B,) max |Δ| of each row's last logits against the prefill of T + 1
        return (full[:, -1] - dec[:, -1]).abs().amax(-1)

    full = nxt = rec_full = None
    readings, caches = {}, {}
    for cache_dtype in (torch.float32, torch.bfloat16):
        name = str(cache_dtype).removeprefix("torch.")
        t0 = time.monotonic()
        logits, cache = TT.lm_prefill(params, cfg, batch, t_max, torch.float32, cache_dtype)
        prefill_s = spent(torch, t0)
        on_card = all(t.device.type == "cuda" for seg in cache["segments"] for t in seg.values())
        kinds = {}  # one layout a segment kind, with how many segments have it
        for seg, c in zip(TT.program(cfg), cache["segments"]):
            text, n = kinds.get(seg.kind, (", ".join(
                f"{k} {tuple(v.shape)} {str(v.dtype).removeprefix('torch.')}"
                for k, v in c.items()), 0))
            kinds[seg.kind] = (text, n + 1)
        layout = "; ".join(f"{k} ({n} segment{'s' if n > 1 else ''}): {text}"
                           for k, (text, n) in kinds.items())
        if nxt is None:  # the prefill's logits do not depend on the cache's dtype
            nxt = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        t0 = time.monotonic()
        with MoERecorder(torch) as rec_dec:
            dec, _ = api.decode(params, {"tokens": nxt}, cache)
        decode_s = spent(torch, t0)
        if full is None:
            with MoERecorder(torch) as rec_full:
                full, _ = api.prefill(params, {**batch, "tokens": torch.cat(
                    [batch["tokens"], nxt], 1)}, t_max)
        r = dict(prefill_s=prefill_s, decode_s=decode_s, on_card=on_card, layout=layout,
                 err=row_err(dec), flips=[], flipped=torch.zeros_like(nxt[:, 0], dtype=bool),
                 finite=bool(torch.isfinite(logits).all() and torch.isfinite(dec).all()))
        if cfg.moe:
            flipped = [(a.sort(-1).values != b[last].sort(-1).values).any(-1)
                       for (a, _), (b, _) in zip(rec_dec.calls, rec_full.calls)]
            r["flips"], r["flipped"] = [int(f.sum()) for f in flipped], torch.stack(flipped).any(0)
        check(r["finite"] and logits.device.type == "cuda" and on_card,
              f"phase 10 {tag} {arch}: non-finite logits, or not on the card")
        readings[name], caches[name] = r, cache

    pins = [b[last] for b, _ in rec_full.calls] if cfg.moe else None

    def pinned(cache):  # a decode step whose routing is the prefill's
        with MoERecorder(torch, pinned=pins):
            return api.decode(params, {"tokens": nxt}, cache)[0]

    dec32 = pinned(caches["float32"])
    readings["float32"]["pinned"] = row_err(dec32)
    readings["bfloat16"]["pinned"] = row_err(pinned(caches["bfloat16"]))
    values = {"segments": [{k: v.float() for k, v in seg.items()}
                           for seg in caches["bfloat16"]["segments"]],
              "len": caches["bfloat16"]["len"]}
    rounding = float((pinned(values)[:, -1] - dec32[:, -1]).abs().max())
    del caches
    # the model's own sensitivity: the prefill of T + 1 again with every
    # embedding row scaled by 1 + 1e-7·N(0, 1), fp32 rounding's size
    with torch.no_grad():
        kept = params["embed"].clone()
        gen = torch.Generator(dev).manual_seed(9)
        params["embed"].mul_(1 + 1e-7 * torch.randn(kept.shape, generator=gen, device=dev))
        again, _ = api.prefill(params, {**batch, "tokens": torch.cat([batch["tokens"], nxt], 1)},
                               t_max)
        params["embed"].copy_(kept)
    sens = float((again[:, -1] - full[:, -1]).abs().max())
    base = max(2e-2, CHAOS_MARGIN * sens)
    top = float(full.abs().max())
    print(f"phase 10 {tag} {arch}: the prefill of T + 1 with its embeddings scaled by 1 + 1e-7·N(0,"
          f" 1) moves the last logits by {sens:.3e}: bound max(2e-2, {CHAOS_MARGIN} × that) = "
          f"{base:.3e}; the fp32 decode step from the bf16 cache's values moves by "
          f"{rounding:.3e}: bf16 cache bound max(that bound, 2 × this) = "
          f"{max(base, 2 * rounding):.3e}  [{card}]")
    for name, r in readings.items():
        bound = max(base, 2 * rounding) if name == "bfloat16" else base
        steady = float(torch.where(r["flipped"], 0.0, r["err"]).max())
        routed = (f"; the decoded tokens' routed selections differing from the prefill's in "
                  f"{sum(r['flips'])} of {len(r['flips']) * LM_SHAPE['batch']} (token × layer; "
                  f"by layer {r['flips']}); the {int((~r['flipped']).sum())} rows with none "
                  f"{steady:.3e}; routing pinned to the prefill's {float(r['pinned'].max()):.3e}"
                  if cfg.moe else "")
        print(f"phase 10 {tag} {arch}, {name} cache: prefill {r['prefill_s'] * 1e3:.1f} ms, one "
              f"decode step {r['decode_s'] * 1e3:.1f} ms (the first of each cache); prefill/decode "
              f"max |Δ| {float(r['err'].max()):.3e} (max |logit| {top:.3f}, bound {bound:.3e}"
              f"{' on the rows with no flip and pinned' if cfg.moe else ''}), finite "
              f"{r['finite']}{routed}; cache on the card {r['on_card']}: {r['layout']}  [{card}]")
        check(steady <= bound and float(r["pinned"].max()) <= bound,
              f"phase 10 {tag} {arch}, {name} cache: prefill/decode differ by {steady} "
              f"(rows with no flip), {float(r['pinned'].max())} (routing pinned)")
    del params
    torch.cuda.empty_cache()


def lm_card_vs_cpu(torch, card, label, arch, depth):
    """(c), (d), (h): the same parameters and prompts on the card and on the
    CPU, fp32 compute (TF32 off): a prefill and LM_STEPS greedy decode
    steps, each side fed its own tokens, greedy tokens equal, and for an
    MoE model the routed selections equal token by token. With an fp32
    cache (``lm_prefill``'s ``cache_dtype``) the arithmetic is fp32
    throughout: logits within 1e-3 · max |logit|. With the serving default,
    a bf16 cache, decode rounds k/v and the attention weights to bf16, and
    the two devices' fp32 sums may round to neighbouring bf16 values:
    logits within the reference's own bound for what that cache does, 2e-2
    (tests/test_models.py). ``depth`` cuts the full width's layers; None
    runs ``reduced()``."""
    import copy
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.launch import serve
    from repro_torch.models import registry, transformer as TT

    cfg = ARCHS[arch]
    cfg = cfg.reduced() if depth is None else dataclasses.replace(cfg, n_layers=depth)
    t_max = LM_SHAPE["prompt_len"] + LM_SHAPE["gen"] + (cfg.vis_ctx or 0)
    torch.cuda.empty_cache()
    cpu_params = registry.build(cfg, device="cpu").init()
    card_params = copy.deepcopy(cpu_params).to(torch.device("cuda"))
    batch = serve.prompts(cfg, LM_SHAPE["batch"], LM_SHAPE["prompt_len"], "cpu")
    for cache_dtype, bound in ((torch.float32, None), (torch.bfloat16, 2e-2)):
        runs = []
        for params in (card_params, cpu_params):
            dev = params["embed"].device
            api = registry.build(cfg, compute_dtype=torch.float32, device=dev)
            with MoERecorder(torch) as rec:
                t0 = time.monotonic()
                logits, cache = TT.lm_prefill(params, cfg,
                                              {k: v.to(dev) for k, v in batch.items()},
                                              t_max, torch.float32, cache_dtype)
                steps, toks = [logits.cpu()], []
                for _ in range(LM_STEPS):
                    tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
                    toks.append(tok.cpu())
                    logits, cache = api.decode(params, {"tokens": tok}, cache)
                    steps.append(logits.cpu())
                secs = spent(torch, t0) if dev.type == "cuda" else time.monotonic() - t0
            sels = [sel.sort(dim=-1).values.cpu() for sel, _ in rec.calls]
            runs.append((steps, torch.cat(toks, 1), logits.device.type, secs, sels))
        (c_steps, c_tok, c_dev, c_s, c_sel), (p_steps, p_tok, _, p_s, p_sel) = runs
        top = max(float(x.abs().max()) for x in p_steps)
        errs = [float((a - b).abs().max()) for a, b in zip(c_steps, p_steps)]
        same = torch.equal(c_tok, p_tok)
        differ = sum(int((a != b).any(-1).sum()) for a, b in zip(c_sel, p_sel))
        routed = (f"; routed selections differing {differ} of "
                  f"{sum(a.shape[0] for a in c_sel)} (tokens × MoE calls)" if cfg.moe else "")
        name = str(cache_dtype).removeprefix("torch.")
        limit = 1e-3 * top if bound is None else bound
        print(f"phase 10 {label}, {name} cache: prefill + {LM_STEPS} decode steps, card "
              f"{c_s:.3f} s, CPU {p_s:.3f} s; logits max |Δ| by step "
              f"{', '.join(f'{e:.3e}' for e in errs)} (limit {limit:.3e}, max |logit| "
              f"{top:.3f}); greedy tokens equal {same} {c_tok[0].tolist()}{routed}  [{card}]")
        check(c_dev == "cuda", f"phase 10 {label}: the card run fell back to {c_dev}")
        check(max(errs) <= limit and same, f"phase 10 {label}, {name} cache: the card and the "
              "CPU differ")
        check(len(c_sel) == len(p_sel), f"phase 10 {label}: MoE calls differ")
    del card_params
    torch.cuda.empty_cache()


def mixer_oracles(torch, card):
    """(i) the reference's own oracles at full width on the card, fp32 (TF32
    off), T = ORACLE_T (padded to whole chunks): ``mamba2_forward`` against
    ``mamba2_recurrent_ref`` (zamba2's mixer) and ``rwkv6_mix_chunked``
    against ``rwkv6_mix_recurrent`` (rwkv6-3b's), outputs and final states
    within 1e-4 · max(1, max |value|) (the reference's 1e-4,
    tests/test_models.py:99-116, scaled to the full width's values)."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import rwkv6, ssm

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(5)
    # (arch, init, chunked, recurrent, where the returned states hold the
    # carried one: Mamba2's (conv, ssm), RWKV6's (wkv, token shift))
    for arch, init, chunked, recurrent, at in (
            ("zamba2-1.2b", ssm.mamba2_init, ssm.mamba2_forward, ssm.mamba2_recurrent_ref, 1),
            ("rwkv6-3b", rwkv6.rwkv6_mix_init, rwkv6.rwkv6_mix_chunked,
             rwkv6.rwkv6_mix_recurrent, 0)):
        cfg = ARCHS[arch]
        p = init(gen, cfg, torch.float32)
        x = torch.randn((2, ORACLE_T, cfg.d_model), generator=gen, device=dev) * 0.5
        with torch.inference_mode():
            t0 = time.monotonic()
            y1, st1 = chunked(p, cfg, x)
            c_s = spent(torch, t0)
            t0 = time.monotonic()
            y2, st2 = recurrent(p, cfg, x)
            r_s = spent(torch, t0)
        ey, es = float((y1 - y2).abs().max()), float((st1[at] - st2[at]).abs().max())
        ly = 1e-4 * max(1.0, float(y2.abs().max()))
        ls = 1e-4 * max(1.0, float(st2[at].abs().max()))
        q = cfg.ssm.chunk
        print(f"phase 10 (i) {arch} mixer at full width (d_model {cfg.d_model}), T {ORACLE_T} "
              f"padded to {-(-ORACLE_T // q) * q} (chunk {q}): chunked {c_s * 1e3:.1f} ms, "
              f"recurrent {r_s * 1e3:.1f} ms (first calls); max |Δ| output {ey:.3e} (limit "
              f"{ly:.3e}), state {es:.3e} (limit {ls:.3e})  [{card}]")
        check(ey <= ly and es <= ls and bool(torch.isfinite(y1).all()),
              f"phase 10 (i) {arch}: the chunked form and the recurrence differ")
    torch.cuda.empty_cache()


def moe_repeatable(torch, card):
    """(j) one full-width qwen2-moe MoE layer (bf16 compute, fp32
    parameters) on the (e) prompt's shape, run twice: the outputs bitwise
    equal (the combine is one fixed-order sum a token)."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import moe

    cfg = ARCHS[MOE_ARCH]
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(7)
    p = moe.moe_init(gen, cfg, torch.float32)
    x = (torch.randn((LM_SHAPE["batch"], LM_SHAPE["prompt_len"], cfg.d_model), generator=gen,
                     device=dev) * 0.5).bfloat16()
    with torch.inference_mode():
        a, b = (moe.moe_apply(p, cfg, x)[0] for _ in range(2))
    same = torch.equal(a, b)
    print(f"phase 10 (j) {MOE_ARCH} MoE layer, {x.shape[0] * x.shape[1]} tokens, bf16: two runs "
          f"bitwise equal {same}  [{card}]")
    check(same, "phase 10 (j): the MoE combine is not repeatable")
    del p
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 11: Whisper served, and single-card training
WHISPER = "whisper-large-v3"  # 32 + 32 layers, d_model 1280, 20 heads, enc_ctx 1500
W_DEPTH = 2  # (c), (e): the full width cut to this many encoder and decoder layers
W_ENC_CTX = 256  # (e): the training comparison's encoder context, cut from 1500
TRAIN_SHAPE = dict(batch=8, seq=128, steps=8)  # (d)
TRAIN_CUT = dict(batch=2, seq=64)  # (e)
# (e): tolerances, stated before the run. fp32 on both devices (TF32 off),
# sums in other orders: the loss to 1e-5 · |loss|; a gradient leaf to 1e-4 ·
# max |leaf| + 1e-6 · max |grad| over the tree; a parameter after the AdamW
# step to 1e-6 · max(1, max |p|) of its leaf plus lr · min(2, 2 δ_g / (|g| +
# eps)) with δ_g the element's gradient tolerance (Adam's first step is lr ·
# g / (|g| + eps), which δ_g moves by at most that)
TRAIN_TOL = dict(loss=1e-5, grad=1e-4, grad_floor=1e-6, param=1e-6)
FLASH_TOL = 1e-4  # (g): fp32 flash backward against autograd through sdpa_ref, × max(1, max |y|)


def lm_training(torch, card):
    """Phase 11: Whisper's serving path and the single-card training path,
    with the launch counts reset just before and read just after (neither
    has a hand kernel: every count stays 0)."""
    from repro_torch.kernels import build

    t_phase = time.monotonic()
    build.reset_launches()
    whisper_serving(torch, card)
    whisper_consistency(torch, card)
    whisper_card_vs_cpu(torch, card)
    train_full_width(torch, card)
    train_card_vs_cpu(torch, card)
    train_launcher(torch, card)
    flash_backward_shapes(torch, card)
    got = nonzero(dict(build.LAUNCHES))
    print(f"phase 11: {time.monotonic() - t_phase:.1f} s, hand-kernel launches {json.dumps(got)}"
          f"  [{card}]")
    check(not got, f"phase 11: Whisper or training launched hand kernels {got}")
    torch.cuda.empty_cache()


def whisper_inputs(torch, cfg, b, t, dev):
    """Seeded prompt tokens and stub frames (B, enc_ctx, d_model) · 0.1."""
    gen = torch.Generator(dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (b, t), generator=gen, device=dev, dtype=torch.int32)
    frames = torch.randn((b, cfg.enc_ctx, cfg.d_model), generator=gen, device=dev) * 0.1
    return {"tokens": tokens, "frames": frames}


def whisper_serving(torch, card):
    """(a) whisper-large-v3 uncut (seed-0 weights, fp32 parameters, bf16
    compute, a bf16 cache): batch 4, 32-token prompts, 16 greedy tokens
    through ``registry.build``'s prefill and decode (``serve.generate``),
    twice; the encoder alone; peak memory; a steady decode step traced."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch import serve
    from repro_torch.models import registry, whisper as TW

    cfg = ARCHS[WHISPER]
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    api = registry.build(cfg, compute_dtype=torch.bfloat16, device=dev)
    params = api.init()
    n_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    b, t, gen = LM_SHAPE["batch"], LM_SHAPE["prompt_len"], LM_SHAPE["gen"]
    batch = whisper_inputs(torch, cfg, b, t, dev)
    t_max = t + gen
    print(f"phase 11 (a) {WHISPER} uncut ({cfg.n_enc_layers} + {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads, enc_ctx {cfg.enc_ctx}, vocab {cfg.vocab} padded "
          f"{cfg.padded_vocab}): {n_bytes / 1e9:.3f} GB of fp32 parameters  [{card}]")
    for run in ("first", "again"):
        toks, t_prefill, t_decode = serve.generate(api, params, batch, t_max, gen)
        print(f"phase 11 (a) {run} call, bf16 compute, batch {b}: prefill (encode + {t}-token "
              f"prompt) {t_prefill * 1e3:.1f} ms; decode {gen - 1} steps -> "
              f"{b * (gen - 1) / t_decode:.1f} tok/s; tokens {toks[0, :8].tolist()}  [{card}]")
        check(toks.shape == (b, gen) and bool(((toks >= 0) & (toks < cfg.vocab)).all()),
              "phase 11 (a): generated tokens out of range")
    with torch.inference_mode():
        enc = traced(torch, lambda: TW.encode(params, cfg, batch["frames"], torch.bfloat16,
                                              remat=False), reps=5)
    print(f"phase 11 (a) encoder alone, {b} × {cfg.enc_ctx} frames: {enc['text']}  [{card}]")
    logits, cache = api.prefill(params, batch, t_max)
    check(bool(torch.isfinite(logits).all()), "phase 11 (a): non-finite prefill logits")
    tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
    # rewrites the cache's slot `len` each call: the same step again
    step = traced(torch, lambda: api.decode(params, {"tokens": tok}, cache))
    print(f"phase 11 (a) decode step, cache of {t_max} + cross k/v of {cfg.enc_ctx}: "
          f"{step['text']}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"reading the parameters once takes {n_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms at 3.35 "
          f"TB/s (bytes)  [{card}]")
    del params, cache
    torch.cuda.empty_cache()


def whisper_consistency(torch, card):
    """(b) as (a) in fp32 compute (TF32 off): a decode step after a prefill
    of T against the prefill of T + 1, through an fp32 and a bf16 cache,
    held by phase 10's rule: the fp32 cache to max(2e-2, CHAOS_MARGIN × the
    model's response to its embeddings scaled by 1 + 1e-7·N(0, 1)); the
    bf16 cache to the larger of that and 2 × what the bf16 cache's stored
    values' rounding moves the fp32 decode step."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import registry, whisper as TW

    cfg = ARCHS[WHISPER]
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    api = registry.build(cfg, compute_dtype=torch.float32, device=dev)
    params = api.init()
    b, t = LM_SHAPE["batch"], LM_SHAPE["prompt_len"]
    batch = whisper_inputs(torch, cfg, b, t, dev)
    t_max = t + LM_SHAPE["gen"]
    full, nxt, errs, caches, decs = None, None, {}, {}, {}
    for cache_dtype in (torch.float32, torch.bfloat16):
        name = str(cache_dtype).removeprefix("torch.")
        logits, cache = TW.whisper_prefill(params, cfg, batch, t_max, torch.float32, cache_dtype)
        if nxt is None:
            nxt = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        decs[name], _ = api.decode(params, {"tokens": nxt}, cache)
        if full is None:
            full, _ = api.prefill(params, {**batch, "tokens": torch.cat([batch["tokens"], nxt],
                                                                         1)}, t_max)
        errs[name] = float((full[:, -1] - decs[name][:, -1]).abs().max())
        caches[name] = cache
        check(bool(torch.isfinite(logits).all() and torch.isfinite(decs[name]).all()),
              f"phase 11 (b): non-finite logits ({name} cache)")
    c16 = caches["bfloat16"]
    values = {**c16, "self": {k: v.float() for k, v in c16["self"].items()},
              "cross_k": c16["cross_k"].float(), "cross_v": c16["cross_v"].float()}
    rounding = float((api.decode(params, {"tokens": nxt}, values)[0][:, -1]
                      - decs["float32"][:, -1]).abs().max())
    del caches, values, c16
    with torch.no_grad():
        kept = params["embed"].clone()
        gen = torch.Generator(dev).manual_seed(9)
        params["embed"].mul_(1 + 1e-7 * torch.randn(kept.shape, generator=gen, device=dev))
        again, _ = api.prefill(params, {**batch, "tokens": torch.cat([batch["tokens"], nxt], 1)},
                               t_max)
        params["embed"].copy_(kept)
    sens = float((again[:, -1] - full[:, -1]).abs().max())
    base = max(2e-2, CHAOS_MARGIN * sens)
    bounds = {"float32": base, "bfloat16": max(base, 2 * rounding)}
    print(f"phase 11 (b) {WHISPER} uncut, fp32 compute: embeddings scaled by 1 + 1e-7·N(0, 1) "
          f"move the last logits by {sens:.3e}; the bf16 cache's stored values move the fp32 "
          f"step by {rounding:.3e}; prefill/decode max |Δ| fp32 cache {errs['float32']:.3e} "
          f"(bound {bounds['float32']:.3e}), bf16 cache {errs['bfloat16']:.3e} (bound "
          f"{bounds['bfloat16']:.3e}); max |logit| {float(full.abs().max()):.3f}  [{card}]")
    for name, err in errs.items():
        check(err <= bounds[name], f"phase 11 (b): prefill/decode differ by {err} ({name} cache)")
    del params
    torch.cuda.empty_cache()


def whisper_card_vs_cpu(torch, card):
    """(c) whisper-large-v3 at full width cut to W_DEPTH + W_DEPTH layers
    (enc_ctx 1500 kept), fp32 compute, an fp32 cache: a prefill and
    LM_STEPS greedy decode steps on the card against the port's CPU run,
    logits within 1e-3 · max |logit|, greedy tokens equal."""
    import copy
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.models import registry, whisper as TW

    cfg = dataclasses.replace(ARCHS[WHISPER], n_layers=W_DEPTH, n_enc_layers=W_DEPTH)
    t_max = LM_SHAPE["prompt_len"] + LM_SHAPE["gen"]
    cpu_params = registry.build(cfg, device="cpu").init()
    card_params = copy.deepcopy(cpu_params).to(torch.device("cuda"))
    batch = whisper_inputs(torch, cfg, LM_SHAPE["batch"], LM_SHAPE["prompt_len"], "cpu")
    runs = []
    for params in (card_params, cpu_params):
        dev = params["embed"].device
        api = registry.build(cfg, compute_dtype=torch.float32, device=dev)
        t0 = time.monotonic()
        logits, cache = TW.whisper_prefill(params, cfg, {k: v.to(dev) for k, v in batch.items()},
                                           t_max, torch.float32, torch.float32)
        steps, toks = [logits.cpu()], []
        for _ in range(LM_STEPS):
            tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
            toks.append(tok.cpu())
            logits, cache = api.decode(params, {"tokens": tok}, cache)
            steps.append(logits.cpu())
        if dev.type == "cuda":
            torch.cuda.synchronize()
        runs.append((steps, torch.cat(toks, 1), time.monotonic() - t0))
    (c_steps, c_tok, c_s), (p_steps, p_tok, p_s) = runs
    top = max(float(x.abs().max()) for x in p_steps)
    errs = [float((a - b).abs().max()) for a, b in zip(c_steps, p_steps)]
    same = torch.equal(c_tok, p_tok)
    print(f"phase 11 (c) {WHISPER} full width cut to {W_DEPTH} + {W_DEPTH} layers, fp32 cache: "
          f"prefill + {LM_STEPS} decode steps, card {c_s:.3f} s, CPU {p_s:.3f} s; logits max |Δ| "
          f"by step {', '.join(f'{e:.3e}' for e in errs)} (limit {1e-3 * top:.3e}, max |logit| "
          f"{top:.3f}); greedy tokens equal {same} {c_tok[0].tolist()}  [{card}]")
    check(max(errs) <= 1e-3 * top and same, "phase 11 (c): the card and the CPU differ")
    del card_params
    torch.cuda.empty_cache()


def train_full_width(torch, card):
    """(d) qwen3-1.7b uncut with ``TrainConfig``'s defaults (bf16 compute,
    fp32 parameters, remat, clip 1.0, weight decay 0.1) and the schedule
    ``launch.train`` gives a run of TRAIN_SHAPE["steps"] steps (its lr
    1e-3, warmup max(steps // 20, 5), total_steps the steps). The data's
    next-token marginal is uniform, so a random model can lose only the
    excess its random logits add to ln V (≈ 0.4 nats) in a few steps; at
    the default lr 3e-4 over 100 warmup steps 8 steps move the loss less
    than batches differ (±0.05). ``make_train_step`` on ``TokenPipeline``
    batches; every loss and gradient norm finite, the last step's loss
    below the first's, and step 0's batch again after the steps (no
    update: its loss without batch-to-batch noise) below its loss at step
    0; the median steady step, tokens/s, peak memory and one step
    traced."""
    from repro_torch import tree as TT
    from repro_torch.configs import ARCHS, TrainConfig
    from repro_torch.data.lm_tokens import TokenPipeline
    from repro_torch.models import registry
    from repro_torch.optim import adamw_init

    cfg = ARCHS[LM_ARCH]
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    n = TRAIN_SHAPE["steps"]
    tcfg = TrainConfig(lr=1e-3, total_steps=n, warmup=max(n // 20, 5))
    params = registry.build(cfg, device=dev).init()
    opt = adamw_init(params)
    n_params = sum(x.numel() for x in TT.leaves(params))
    step = registry.make_train_step(cfg, tcfg, device=dev)
    b, t = TRAIN_SHAPE["batch"], TRAIN_SHAPE["seq"]
    pipe = TokenPipeline(cfg.vocab, t, b, device=dev)
    metrics, secs = [], []
    for i in range(n):
        batch = pipe.batch(i)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        params, opt, m = step(params, opt, batch)
        secs.append(spent(torch, t0))
        metrics.append(m)
    losses = [float(m["loss"]) for m in metrics]
    gnorms = [float(m["gnorm"]) for m in metrics]
    steady = sorted(secs[1:])[len(secs[1:]) // 2]
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"phase 11 (d) {LM_ARCH} uncut ({n_params / 1e9:.3f} B parameters), TrainConfig "
          f"defaults (lr {tcfg.lr}, warmup {tcfg.warmup} of {tcfg.total_steps} steps), batch "
          f"{b} × {t}: step seconds {', '.join(f'{x:.3f}' for x in secs)}; median "
          f"steady step {steady * 1e3:.1f} ms, {b * t / steady:.0f} tokens/s; peak memory "
          f"{peak:.2f} GiB  [{card}]")
    print(f"phase 11 (d) losses {', '.join(f'{x:.4f}' for x in losses)}; gradient norms "
          f"{', '.join(f'{x:.3f}' for x in gnorms)}; lr at the last step "
          f"{float(metrics[-1]['lr']):.3e}  [{card}]")
    with torch.no_grad():
        held = float(registry.build(cfg, device=dev).loss(params, pipe.batch(0))[0])
    print(f"phase 11 (d) step 0's batch after the {n} steps: loss {held:.4f} (at step 0 "
          f"{losses[0]:.4f})  [{card}]")
    check(all(math.isfinite(x) for x in losses + gnorms), "phase 11 (d): a non-finite loss or norm")
    check(losses[-1] < losses[0] and held < losses[0],
          f"phase 11 (d): the loss did not fall ({losses[0]} -> {losses[-1]}; step 0's batch "
          f"{held})")
    batch = pipe.batch(n)
    one = traced(torch, lambda: step(params, opt, batch), reps=1, warm=False)
    print(f"phase 11 (d) one traced step: {one['text']}  [{card}]")
    del params, opt
    torch.cuda.empty_cache()


def train_card_vs_cpu(torch, card):
    """(e) one ``make_train_step`` (fp32 compute, remat, the default
    schedule and clip) on the card against the port's CPU run from the same
    parameters and batch: qwen3-1.7b at full width cut to LM_DEPTH layers
    and whisper-large-v3 at full width cut to W_DEPTH + W_DEPTH layers with
    enc_ctx cut to W_ENC_CTX, batch TRAIN_CUT. The loss, every gradient
    leaf, and every parameter after the AdamW step, to TRAIN_TOL (stated
    above). Then the card's step again from a copy of the same state:
    bitwise equal (the replay the supervisor relies on)."""
    import copy
    import dataclasses

    from repro_torch import tree as TT
    from repro_torch.configs import ARCHS, TrainConfig
    from repro_torch.models import registry
    from repro_torch.optim import adamw_init

    tcfg = TrainConfig(compute_dtype="float32")
    lr0 = tcfg.lr / tcfg.warmup  # the first step's rate
    b, t = TRAIN_CUT["batch"], TRAIN_CUT["seq"]
    cases = ((f"{LM_ARCH} full width cut to {LM_DEPTH} layers",
              dataclasses.replace(ARCHS[LM_ARCH], n_layers=LM_DEPTH)),
             (f"{WHISPER} full width cut to {W_DEPTH} + {W_DEPTH} layers, enc_ctx cut to "
              f"{W_ENC_CTX}", dataclasses.replace(ARCHS[WHISPER], n_layers=W_DEPTH,
                                                  n_enc_layers=W_DEPTH, enc_ctx=W_ENC_CTX)))
    for label, cfg in cases:
        gen = torch.Generator().manual_seed(3)
        toks = torch.randint(0, cfg.vocab, (b, t + 1), generator=gen, dtype=torch.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.family == "audio":
            batch["frames"] = torch.randn((b, cfg.enc_ctx, cfg.d_model), generator=gen) * 0.1
        cpu_params = registry.build(cfg, device="cpu").init()
        runs = {}
        for name in ("card", "cpu", "card again"):
            dev = torch.device("cpu" if name == "cpu" else "cuda")
            params = copy.deepcopy(cpu_params).to(dev)
            opt = adamw_init(params)
            api = registry.build(cfg, compute_dtype=torch.float32, device=dev)
            on = {k: v.to(dev) for k, v in batch.items()}
            params.requires_grad_(True)
            loss, _ = api.loss(params, on)
            grads = torch.autograd.grad(loss, TT.leaves(params), allow_unused=True,
                                        materialize_grads=True)
            step = registry.make_train_step(cfg, tcfg, device=dev)
            t0 = time.monotonic()
            params, opt, m = step(params, opt, on)
            secs = spent(torch, t0) if dev.type == "cuda" else time.monotonic() - t0
            runs[name] = dict(loss=loss.detach().cpu(), grads=[g.cpu() for g in grads],
                              params=[p.detach().cpu() for p in TT.leaves(params)],
                              m=[x.cpu() for x in TT.leaves(opt["m"])],
                              metrics={k: v.cpu() for k, v in m.items()}, secs=secs)
            del params, opt, grads
        on_card, cpu, again = runs["card"], runs["cpu"], runs["card again"]
        lerr = abs(float(on_card["loss"]) - float(cpu["loss"]))
        ltol = TRAIN_TOL["loss"] * abs(float(cpu["loss"]))
        gmax = max(float(g.abs().max()) for g in cpu["grads"])
        g_tols = [TRAIN_TOL["grad"] * float(g.abs().max()) + TRAIN_TOL["grad_floor"] * gmax
                  for g in cpu["grads"]]
        g_ratio = max(float((a - w).abs().max()) / tol
                      for a, w, tol in zip(on_card["grads"], cpu["grads"], g_tols))
        p_ratio = 0.0
        clip = min(1.0, tcfg.grad_clip / max(float(cpu["metrics"]["gnorm"]), 1e-9))
        for a, w, g, tol in zip(on_card["params"], cpu["params"], cpu["grads"], g_tols):
            bound = (TRAIN_TOL["param"] * max(1.0, float(w.abs().max()))
                     + lr0 * torch.clamp(2 * tol * clip / (g.abs() * clip + 1e-8), max=2.0))
            p_ratio = max(p_ratio, float(((a - w).abs() / bound).max()))
        same = all(torch.equal(x, y) for k in ("grads", "params", "m")
                   for x, y in zip(on_card[k], again[k])) and \
            all(torch.equal(on_card["metrics"][k], again["metrics"][k]) for k in again["metrics"])
        print(f"phase 11 (e) {label}, fp32, batch {b} × {t}: train step card "
              f"{on_card['secs']:.3f} s, CPU {cpu['secs']:.3f} s; loss {float(cpu['loss']):.6f}, "
              f"|Δ| {lerr:.3e} (tolerance "
              f"{ltol:.3e}); {len(g_tols)} gradient leaves, largest |Δ| / tolerance "
              f"{g_ratio:.3f}; parameters after the AdamW step, largest |Δ| / tolerance "
              f"{p_ratio:.3f}; the card's step again from the same state bitwise equal {same}"
              f"  [{card}]")
        check(lerr <= ltol and g_ratio <= 1.0 and p_ratio <= 1.0,
              f"phase 11 (e) {label}: the card and the CPU differ")
        check(same, f"phase 11 (e) {label}: two runs of one step differ")
    torch.cuda.empty_cache()


def train_launcher(torch, card):
    """(f) ``python -m repro_torch.launch.train --arch qwen3-1.7b --reduced
    --steps 12 --ckpt-every 4 --inject-failure 6`` on the card in a
    subprocess, into a temporary directory, beside the same run with no
    failure (the two started together): 1 restart, and its loss history
    bitwise the uninterrupted one's (steps 0-5, then the checkpoint after
    step 3 restored and steps 4-11 replayed). Then one train step twice
    from one state, in bf16 compute at TRAIN_SHAPE, of reduced qwen3-1.7b,
    qwen2-moe-a2.7b and whisper-large-v3: parameters, m, v and metrics
    bitwise equal."""
    import copy
    import tempfile

    from repro_torch import tree as TT
    from repro_torch.configs import ARCHS, TrainConfig
    from repro_torch.data.lm_tokens import TokenPipeline
    from repro_torch.models import registry
    from repro_torch.optim import adamw_init

    argv = ["--arch", LM_ARCH, "--reduced", "--steps", "12", "--ckpt-every", "4"]
    with tempfile.TemporaryDirectory() as tmp:
        env = {**os.environ, "PYTHONPATH": str(SRC)}
        t0 = time.monotonic()
        procs = {}
        for name, extra in (("failed", ["--inject-failure", "6"]), ("clean", [])):
            cmd = [sys.executable, "-m", "repro_torch.launch.train", *argv, *extra,
                   "--ckpt", f"{tmp}/{name}", "--history", f"{tmp}/{name}.json"]
            procs[name] = (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True, env=env,
                                                 cwd=tmp))
        outs = {}
        for name, (cmd, proc) in procs.items():
            out, _ = proc.communicate(timeout=300)
            check(proc.returncode == 0, f"phase 11 (f) {' '.join(cmd[2:])} exited "
                  f"{proc.returncode}:\n{out[-2000:]}")
            outs[name] = (out, json.loads(Path(f"{tmp}/{name}.json").read_text()))
        secs = time.monotonic() - t0
    (f_out, failed), (_, clean) = outs["failed"], outs["clean"]
    done = [line for line in f_out.splitlines() if line.startswith("[train] done")]
    want = clean["losses"][:6] + clean["losses"][4:]
    same = failed["losses"] == want
    print(f"phase 11 (f) python -m repro_torch.launch.train {' '.join(argv)} --inject-failure 6 "
          f"(and without the failure, together: {secs:.1f} s): {done[0] if done else '?'}; "
          f"{failed['restarts']} restart, {len(failed['losses'])} losses recorded, bitwise the "
          f"uninterrupted run's {same} (losses {clean['losses'][0]:.4f} -> "
          f"{clean['losses'][-1]:.4f})  [{card}]")
    check(failed["restarts"] == 1 and failed["steps_done"] == 12 and same,
          "phase 11 (f): the restarted run is not the uninterrupted one")

    b, t = TRAIN_SHAPE["batch"], TRAIN_SHAPE["seq"]
    dev = torch.device("cuda")
    for arch in (LM_ARCH, MOE_ARCH, WHISPER):
        cfg = ARCHS[arch].reduced()
        params = registry.build(cfg, device=dev).init()
        opt = adamw_init(params)
        batch = TokenPipeline(cfg.vocab, t, b, device=dev).batch(0)
        if cfg.family == "audio":
            batch["frames"] = whisper_inputs(torch, cfg, b, 1, dev)["frames"]
        step = registry.make_train_step(cfg, TrainConfig(), device=dev)
        outs = []
        for _ in range(2):
            p, o, m = step(copy.deepcopy(params), TT.tree_map(torch.clone, opt), batch)
            outs.append(TT.leaves((p, o, m)))
        same = all(torch.equal(x, y) for x, y in zip(*outs))
        print(f"phase 11 (f) {arch} reduced, bf16 compute, batch {b} × {t}: one train step twice "
              f"from one state, {len(outs[0])} tensors bitwise equal {same}  [{card}]")
        check(same, f"phase 11 (f) {arch}: two runs of one train step differ")
    torch.cuda.empty_cache()


def flash_backward_shapes(torch, card):
    """(g) the flash backward (fp32 operands) at the card's shapes against
    autograd through the dense ``sdpa_ref`` in fp32: whisper's encoder
    self-attention (batch 4, T = 1500, 20 heads of 64, "none") and qwen3's
    training attention (batch 8, T = 128, causal, 8 KV heads × G = 2 of
    128); dq, dk, dv within FLASH_TOL · max(1, max |y|), and both times."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import flash

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(11)
    for label, (b, t, kv, g, dh), kind in (
            (f"{WHISPER} encoder", (LM_SHAPE["batch"], ARCHS[WHISPER].enc_ctx, 20, 1, 64), "none"),
            (f"{LM_ARCH} training", (TRAIN_SHAPE["batch"], TRAIN_SHAPE["seq"], 8, 2, 128),
             "causal")):
        q = torch.randn((b, t, kv, g, dh), generator=gen, device=dev, requires_grad=True)
        k, v = (torch.randn((b, t, kv, dh), generator=gen, device=dev, requires_grad=True)
                for _ in range(2))
        do = torch.randn((b, t, kv, g, dh), generator=gen, device=dev)
        grads, secs = {}, {}
        for name, fn in (("flash", flash.flash_attention), ("sdpa_ref", flash.sdpa_ref)):
            fn(q, k, v, dh ** -0.5, kind)  # warm
            torch.cuda.synchronize()
            t0 = time.monotonic()
            out = fn(q, k, v, dh ** -0.5, kind)
            grads[name] = torch.autograd.grad(out, (q, k, v), do)
            secs[name] = spent(torch, t0)
        errs = [float((a - w).abs().max()) / max(1.0, float(w.abs().max()))
                for a, w in zip(grads["flash"], grads["sdpa_ref"])]
        print(f"phase 11 (g) flash backward at {label}'s shape {tuple(q.shape)}, {kind}: max |Δ| "
              f"/ max(1, max |y|) dq {errs[0]:.3e}, dk {errs[1]:.3e}, dv {errs[2]:.3e} (limit "
              f"{FLASH_TOL:.0e}); forward + backward flash {secs['flash'] * 1e3:.2f} ms, dense "
              f"{secs['sdpa_ref'] * 1e3:.2f} ms (one call each, warm)  [{card}]")
        check(max(errs) <= FLASH_TOL, f"phase 11 (g) {label}: the flash backward differs")
    torch.cuda.empty_cache()


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
