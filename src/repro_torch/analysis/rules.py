"""Layer 1 — AST lint rules (``RPR0xx``) over ``src/repro_torch``.

Stdlib-``ast`` checks enforcing the host/device seam contracts of the
port, the counterparts of ``src/repro/analysis/rules.py``:

  RPR001  host-sync primitive on the per-chunk path (a ``HOT`` function)
  RPR002  host-sync seam in library code without an ALLOWLIST entry
  RPR003  ``time.perf_counter`` outside ``src/repro_torch/obs``
  RPR004  a kernel wrapper that chooses its plain version by anything but
          its tensors' device (a flag, a fallback around ``build.launch``)
  RPR005  ``lru_cache``/``cache`` without a literal maxsize; a
          ``capture.run`` key field outside ``STATIC_KEY_ALLOWLIST``

The host-sync primitives are ``.item()``, ``.tolist()``, ``.cpu()``,
``.numpy()``, ``torch.nonzero``/``.nonzero()``, ``torch.equal``,
``torch.cuda.synchronize``, ``Event.synchronize`` (any ``.synchronize()``)
and ``int(``/``float(``/``bool(`` of a tensor expression. Whether an
argument is a tensor is decided statically and conservatively: a
``torch.*`` call, a tensor method (``.sum()``, ``.max()``, …), a name
bound to one in the same function, or a call of a port function annotated
``-> torch.Tensor``; ``.shape`` arithmetic, numpy and Python numbers are
host values. What Layer 1 cannot see, Layer 2 sees at run time.

The reference marks its per-chunk path with ``jax.jit``; the port has no
such marker, so the path is a declared table, :data:`HOT`, of
``module::function``: the chunk functions and their commits, the kernel
wrappers and their plain versions, and the step bodies ``batch/capture.py``
records. Layer 2 (``dispatch.py``, RPR102) proves the table complete: every
port function that runs an op inside an entry's per-chunk path must be in
it.

The seam :data:`ALLOWLIST` is the machine-readable registry of every place
the architecture *intends* a host sync: the level-plan barriers (the next
level's shapes depend on the card's max degree), the end-of-run result
materialisation, orientation (ROADMAP item 10c), the recording of a CUDA
graph, and the obs layer's ``sp.sync()``. Findings at those keys never
surface; a new sync anywhere else fails until it is removed or added here
with a justification. ``launch/`` (the command-line drivers) and
``analysis/`` (this suite, which syncs to check) are exempt from RPR002.
"""
from __future__ import annotations

import ast
from pathlib import Path, PurePosixPath

from .findings import Finding, register_rule

RPR001 = register_rule(
    "RPR001", "host-sync primitive on the per-chunk path (a HOT function)"
)
RPR002 = register_rule(
    "RPR002", "host-sync seam in library code without an allowlist entry"
)
RPR003 = register_rule(
    "RPR003", "time.perf_counter outside src/repro_torch/obs (spans are the timing seam)"
)
RPR004 = register_rule(
    "RPR004", "kernel wrapper choosing its plain version by anything but the tensors' device"
)
RPR005 = register_rule(
    "RPR005", "implicit-maxsize lru_cache/cache, or a capture key field outside the allowlist"
)

PACKAGE_DIR = "src/repro_torch"

#: The per-chunk path, ``module::function`` (module relative to the
#: package): every function a chunk runs or a CUDA-graph recording
#: captures. A nested function is named by itself.
HOT: frozenset[str] = frozenset(
    [f"core/levels.py::{f}" for f in (
        "_f32", "level0", "max_degree", "level0_fill", "level0_span", "level0_g2", "_jtable",
        "_unrank_dyn", "plan_sets", "_set_mask", "gather_s", "gather_sets", "subset_cols",
        "gather_s_cols", "_require_fp32_matmul", "_inv_spd", "_set_inverse", "_sum_in_order",
        "_sweep_terms_in_order", "ci_sweep", "_tests_s", "_tests_s_cols", "_chunk_ranks",
        "chunk_s", "chunk_s_tests", "chunk_s_commit", "chunk_e", "_winners", "_commit_key_mat",
        "_global_commit", "commit_adj", "commit_sep_rows", "_commit", "commit_dense_l1",
        "g2_worklist", "chunk_g2")]
    + [f"core/cit.py::{f}" for f in ("fisher_z", "chi2_sf_f32", "level0_span")]
    + ["core/compact.py::compact_rows", "device.py::imax", "device.py::rank_dtype"]
    + [f"kernels/ops.py::{f}" for f in (
        "standardize", "correlation", "level0", "level0_span", "gsq", "level1_dense",
        "ci_shared", "ci_shared_grid", "_grid_winners", "chunk_s_grid_tests",
        "chunk_s_grid_tests_cols", "_commit_winners", "chunk_s_grid", "chunk_s_kernel",
        "chunk_s_two_launch")]
    + [f"kernels/build.py::{f}" for f in (
        "library", "launch", "require_cuda", "_current_stream")]
    + [f"kernels/corr.py::{f}" for f in (
        "_upper_tiles", "plan", "_sm_count", "corr_matmul_plain", "corr_matmul")]
    + [f"kernels/level0.py::{f}" for f in ("_check", "level0_kernel", "level0_span")]
    + [f"kernels/level1.py::{f}" for f in (
        "atanh_window", "level1_dense_plain", "level1_dense_kernel")]
    + [f"kernels/cholinv.py::{f}" for f in ("_fma", "cholinv_plain", "cholinv")]
    + [f"kernels/cisweep.py::{f}" for f in ("cisweep_plain", "cisweep")]
    + [f"kernels/gsq.py::{f}" for f in ("_check", "gsq_ref", "gsq_cells")]
    + [f"kernels/sgrid.py::{f}" for f in (
        "_inverse", "_rsqrt_rn", "sgrid_plain", "sgrid", "sgrid_fused")]
    + [f"kernels/skernel.py::{f}" for f in (
        "_two_step", "skernel_plain", "skernel_two_launch", "skernel_fused")]
    + [f"batch/scan_pc.py::{f}" for f in (
        "_scan_core", "program", "sweep", "_stack_lanes", "_level_sweep", "_level_sweep_g2",
        "_sweep_plan", "_level_ok", "_use_dense_l1", "_plan_chunk", "_dense_l1",
        "_level1_dense")]
    + ["batch/capture.py::boundary"]
    # the LM serving path: a prefill and a decode step are the per-step path
    + [f"models/transformer.py::{f}" for f in (
        "lm_prefill", "lm_forward", "lm_decode_step", "lm_cache_init", "_layer_cache_init",
        "_embed_inputs", "block_apply", "block_decode", "_ffn_part", "_site_in", "_site_out",
        "_site_apply", "_norm", "_logits")]
    + [f"models/attention.py::{f}" for f in (
        "_qkv", "_promote", "_sdpa", "gqa_forward", "gqa_decode", "gqa_cache_init", "_mla_q",
        "_mla_ckv", "mla_forward", "mla_decode", "mla_cache_init")]
    + [f"models/moe.py::{f}" for f in ("capacity", "route", "slots", "_combine", "moe_apply")]
    + [f"models/ssm.py::{f}" for f in (
        "_dims", "_conv1d_causal", "_split_proj", "_post", "_segsum", "_chunk_step",
        "mamba2_forward", "mamba2_state_init", "mamba2_decode")]
    + [f"models/rwkv6.py::{f}" for f in (
        "_dims", "_ddlerp", "_rkvwg", "_groupnorm_heads", "_shift", "_out", "_chunk_step",
        "rwkv6_mix_chunked", "rwkv6_mix_recurrent", "rwkv6_state_init", "rwkv6_cmix")]
    + [f"models/flash.py::{f}" for f in (
        "_block_bias", "_pad_tk", "_mm_dtype", "_mm_operand", "_block_logits", "_fwd_impl",
        "forward", "backward", "flash_attention")]
    + [f"models/layers.py::{f}" for f in (
        "rmsnorm", "layernorm", "_gelu_tanh", "act_fn", "mlp", "rope_freqs", "apply_rope",
        "unembed", "_ce_chunk", "_chunk_logits", "forward", "backward", "chunked_ce",
        "cross_entropy")]
    # Whisper's serving path, and a train step (loss, backward, clip, AdamW)
    + [f"models/attention.py::{f}" for f in ("cross_kv", "cross_forward")]
    + [f"models/whisper.py::{f}" for f in (
        "_sinusoid", "_positions", "_enc_layer", "encode", "_dec_layer", "_logits", "_decoder",
        "decode_train", "whisper_loss", "whisper_cache_init", "whisper_prefill",
        "whisper_decode_step")]
    + ["models/transformer.py::remat_apply", "models/transformer.py::lm_loss"]
    + [f"models/registry.py::{f}" for f in ("_detached", "_grads", "train_step")]
    + [f"optim/adamw.py::{f}" for f in (
        "warmup_cosine", "_flat", "clip_by_global_norm", "adamw_update", "_groups",
        "_update_group")]
    # training on a named mesh: the sharded step, the anchors, the compressed
    # mean, the pipeline's ticks and the re-meshing
    + [f"models/registry.py::{f}" for f in (
        "sharded_train_step", "_sum_in_order", "split_train_step", "_clip_and_update")]
    # the step in which each rank computes its share, and its collectives
    + [f"models/spmd.py::{f}" for f in (
        "_fetch", "_kv_head", "_lookup", "_masked_logits", "_target", "forward", "backward",
        "_ce_sums", "block", "_microbatch", "split_loss", "layer", "grads")]
    + [f"models/meshops.py::{f}" for f in (
        "current_mesh", "use_mesh", "_filter", "shard_act", "shard_residual", "shard_logits")]
    + ["models/sharding.py::mesh_axes", "optim/adamw.py::norm_and_scale",
       "optim/compress.py::ef_compressed_mean", "state.py::gather_tree",
       "state.py::shard_tree", "state.py::leaves", "state.py::spec_leaves",
       "tree.py::tree_map", "tree.py::as_tree"]
    + [f"core/sharding.py::{f}" for f in (
        "gather_named", "shard_named", "block_slices", "block_index", "distinct_ranks",
        "_distinct_ranks", "spec_axes", "check_spec", "move", "on_rank", "current_rank",
        "each", "_in_order", "_all_gather", "_reduce_scatter", "_pieces", "_all_reduce",
        "forward", "backward", "all_gather", "reduce_scatter", "all_reduce", "copy_to",
        "all_reduce_max", "all_reduce_sum")]
    + [f"distributed/pipeline.py::{f}" for f in ("pipeline_apply", "_stage_device")]
    + ["distributed/elastic.py::_host", "distributed/elastic.py::_regroup"]
)

#: Names a ``capture.run`` key may be built from: each is one recording
#: axis (a static shape, the width schedule, the budget, the jitter, the
#: device, the τ values the kernels take as launch arguments). A new name
#: is a new axis; adding it here is the explicit opt-in (the counterpart
#: of the reference's STATIC_ARGNAME_ALLOWLIST).
STATIC_KEY_ALLOWLIST = frozenset({
    "key", "name", "key_extra", "dev", "inputs", "arrays", "taus", "lane_tau",
    "schedule", "sepset_depth", "cell_budget", "jitter", "test",
})

#: Seam registry: Finding.key -> one-line justification. Keys are
#: line-independent (``CODE path::function::primitive``), so refactors that
#: move a seam within its function do not churn this table.
_P = PACKAGE_DIR
ALLOWLIST: dict[str, str] = {
    # ---- level-plan barriers: the next level's shapes (n′, chunking) depend
    # ---- on the card's max degree; one sync per level by design
    f"RPR002 {_P}/core/levels.py::run_level::int()":
        "per-level plan barrier: chunk shapes derive from the device max degree",
    f"RPR002 {_P}/core/pc.py::_pc_run_host_loop::int()":
        "level-ladder barrier: max_deg decides whether another level runs",
    f"RPR002 {_P}/core/engines.py::_run_level_dense_l1::int()":
        "dense-l1 planner reads the max degree to size the compacted commit",
    f"RPR002 {_P}/core/distributed.py::run_level_sharded::.cpu().numpy()":
        "sharded per-level plan barrier (same contract as levels.run_level)",
    f"RPR002 {_P}/core/distributed.py::_degree_reader::int()":
        "distributed level-ladder barrier on the max degree (CPU tensors: a host read)",
    f"RPR002 {_P}/core/distributed.py::read::.synchronize()":
        "distributed level-ladder barrier: waits on the pinned non_blocking degree copy",
    f"RPR002 {_P}/batch/scan_pc.py::plan_n_prime::int()":
        "scan planner: one sync for the exact level-0 degree bound (documented)",
    f"RPR002 {_P}/batch/scan_pc.py::_prep::int()":
        "discrete scan planner: level-0 degree bound before the recorded build",
    f"RPR002 {_P}/batch/scan_pc.py::scan_levels_batch::int()":
        "batch schedule barrier: the shared width is the batch max degree",
    # ---- end-of-run result materialisation: PCRun/EnsembleRun/ServeResult
    # ---- fields are host numpy by contract (the public API boundary)
    f"RPR002 {_P}/core/pc.py::_pc_run_host_loop::.cpu().numpy()":
        "PCRun materialisation: public result fields are host numpy by contract",
    f"RPR002 {_P}/core/pc.py::_pc_run_scan::.cpu().numpy()":
        "PCRun materialisation of the recorded scan's outputs (API boundary)",
    f"RPR002 {_P}/core/distributed.py::pc_distributed::.cpu().numpy()":
        "PCRun materialisation after the distributed run (API boundary)",
    f"RPR002 {_P}/batch/ensemble.py::bootstrap_pc::.cpu().numpy()":
        "EnsembleRun materialisation: aggregate outputs are host numpy",
    f"RPR002 {_P}/serve/service.py::_run_slot::.cpu().numpy()":
        "slot result materialisation: one host copy of a slot's certificates and graphs",
    f"RPR002 {_P}/serve/service.py::_run_solo::.cpu().numpy()":
        "solo-rung result materialisation: delivered graphs are host numpy",
    f"RPR002 {_P}/serve/service.py::_orient_host::.numpy()":
        "stable-ref rung: orients host arrays on CPU tensors (a view, no device copy)",
    f"RPR002 {_P}/serve/admission.py::sample_correlation::.cpu().numpy()":
        "admission hands a request's C to the host bucket planner (serving boundary)",
    f"RPR002 {_P}/core/validate.py::_as_host::.cpu().numpy()":
        "input validation inspects the caller's array on the host before any run",
    # ---- infrastructure seams
    f"RPR002 {_P}/state.py::run_to_numpy::.cpu().numpy()":
        "checkpointing IS the device->host transfer of a run's state",
    f"RPR002 {_P}/distributed/elastic.py::remesh::.cpu()":
        "re-meshing goes through the host, as the reference's device_get/device_put "
        "(src/repro/distributed/elastic.py:20), on a topology change, not a step",
    f"RPR002 {_P}/checkpoint/manager.py::_to_host::.numpy()":
        "checkpointing IS the device->host transfer of the training state (on the "
        "caller's thread, ordered with the step; the file I/O runs on its own thread)",
    f"RPR002 {_P}/batch/capture.py::__init__::torch.cuda.synchronize":
        "the recording: a CUDA-graph capture starts and ends on an idle device",
    f"RPR002 {_P}/batch/capture.py::__init__::torch.equal":
        "the recording: the first replay is held bitwise to the eager run, once a program",
    f"RPR002 {_P}/obs/trace.py::_synchronize::torch.cuda.synchronize":
        "sp.sync(): the ONE sanctioned sync so span timings measure device work",
    # ---- orientation (ROADMAP item 10c removes these; until then they run
    # ---- eagerly after the skeleton, outside any recorded program)
    f"RPR002 {_P}/core/orient.py::sepset_membership::nonzero":
        "orientation scatters recorded sepset ids (item 10c removes the sync)",
    f"RPR002 {_P}/core/orient.py::_separated_counts::nonzero":
        "orientation counts separated triples from sepset ids (item 10c)",
    f"RPR002 {_P}/core/orient.py::_meek_r3::int()":
        "Meek R3 sizes its neighbour block by the max undirected degree (item 10c)",
    f"RPR002 {_P}/core/orient.py::meek_rules::torch.equal":
        "the Meek fixpoint test on the host (item 10c)",
}

#: Tensor methods whose result is a tensor (an ``int()`` of one syncs).
TENSOR_METHODS = frozenset({
    "sum", "max", "min", "amax", "amin", "mean", "prod", "any", "all", "abs", "argmax",
    "argmin", "count_nonzero", "norm", "std", "var", "clamp", "to", "long", "int", "float",
    "double", "bool", "sqrt", "exp", "log", "cumsum", "diagonal", "flatten", "reshape",
    "view", "squeeze", "unsqueeze", "clone", "contiguous", "eq", "ne", "lt", "le", "gt",
    "ge", "logical_and", "logical_or", "logical_not", "detach", "median", "cuda",
})
#: ``torch.*`` calls that return host values
TORCH_HOST_CALLS = frozenset({
    "is_tensor", "is_floating_point", "numel", "iinfo", "finfo", "device", "dtype", "Size",
    "get_default_dtype", "is_grad_enabled", "equal", "broadcast_shapes", "promote_types",
})
_HOST_ROOTS = ("np.", "numpy.", "math.", "os.", "json.", "time.")
_PLAIN_SUFFIXES = ("_plain", "_ref")
_DEVICE_ATTRS = ("device", "is_cuda", "is_cpu")


def _dotted(node) -> str | None:
    """'torch.cuda.synchronize' for nested Attribute/Name chains, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _tail(node) -> str | None:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _root_name(node) -> str | None:
    while isinstance(node, (ast.Attribute, ast.Subscript, ast.Call)):
        node = node.func if isinstance(node, ast.Call) else node.value
    return node.id if isinstance(node, ast.Name) else None


def _is_host_call(call: ast.Call) -> bool:
    d = _dotted(call.func) or ""
    return d.startswith(_HOST_ROOTS) or d in ("len", "range", "str", "repr", "max", "min",
                                              "abs", "round", "sum")


def annotated_functions(tree: ast.AST, kind: str) -> set[str]:
    """Names of the functions a module defines with a return annotation
    naming ``kind`` alone (``"Tensor"`` or ``"ndarray"``)."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and node.returns is not None:
            ann = ast.unparse(node.returns)
            if kind in ann and "tuple" not in ann:
                out.add(node.name)
    return out


class _Types:
    """Flow-insensitive tensor/host binding of one function's names."""

    def __init__(self, fn, tensor_funcs: set[str], host_funcs: set[str] = frozenset()):
        self.tensor_funcs = tensor_funcs
        self.host_funcs = host_funcs
        self.tensor: set[str] = set()
        self.host: set[str] = set()
        if fn is None:
            return
        args = fn.args
        for a in [*args.posonlyargs, *args.args, *args.kwonlyargs]:
            ann = ast.unparse(a.annotation) if a.annotation is not None else ""
            if "Tensor" in ann:
                self.tensor.add(a.arg)
            elif ann in ("int", "float", "bool", "str"):
                self.host.add(a.arg)
        binds = []
        for node in _own_nodes(fn):
            if isinstance(node, ast.Assign):
                binds += [(t, node.value) for t in node.targets]
            elif isinstance(node, (ast.AnnAssign, ast.AugAssign)) and node.value is not None:
                binds.append((node.target, node.value))
        for _ in range(3):  # to a fixpoint through chains of assignments
            for target, value in binds:
                names = [n.id for n in ast.walk(target) if isinstance(n, ast.Name)]
                if self.is_host(value):
                    self.host.update(names)
                elif self.is_tensor(value):
                    self.tensor.update(n for n in names if n not in self.host)

    def is_host(self, e) -> bool:
        """A numpy/Python value: a numpy or ``math`` call, a ``.numpy()`` /
        ``.tolist()`` / ``.item()`` result, a port function annotated
        ``-> np.ndarray``, a host-bound name, and what is computed from
        them."""
        if isinstance(e, ast.Name):
            return e.id in self.host
        if isinstance(e, ast.Call):
            tail = _tail(e.func)
            if tail in ("numpy", "tolist", "item") or tail in self.host_funcs \
                    or _is_host_call(e):
                return True
            return isinstance(e.func, ast.Attribute) and self.is_host(e.func.value)
        if isinstance(e, (ast.Subscript, ast.Attribute)):
            return self.is_host(e.value)
        if isinstance(e, ast.UnaryOp):
            return self.is_host(e.operand)
        if isinstance(e, ast.BinOp):
            return (self.is_host(e.left) or self.is_host(e.right)) and not (
                self.is_tensor(e.left) or self.is_tensor(e.right))
        return False

    def is_tensor(self, e) -> bool:
        if isinstance(e, ast.Name):
            return e.id in self.tensor
        if isinstance(e, ast.Call):
            d = _dotted(e.func) or ""
            tail = _tail(e.func)
            if d.startswith("torch."):
                return not (d.startswith(("torch.cuda.", "torch.backends."))
                            or tail in TORCH_HOST_CALLS)
            if isinstance(e.func, ast.Attribute) and tail in TENSOR_METHODS:
                root = _root_name(e.func.value)
                return root not in ("np", "numpy", "math") and not self.is_host(e.func.value)
            return tail in self.tensor_funcs
        if isinstance(e, ast.Subscript):
            return self.is_tensor(e.value)
        if isinstance(e, ast.Attribute):
            return e.attr in ("T", "mT", "data") and self.is_tensor(e.value)
        if isinstance(e, ast.BinOp):
            return self.is_tensor(e.left) or self.is_tensor(e.right)
        if isinstance(e, ast.UnaryOp):
            return self.is_tensor(e.operand)
        if isinstance(e, ast.Compare):
            return any(self.is_tensor(x) for x in [e.left, *e.comparators])
        if isinstance(e, ast.BoolOp):
            return any(self.is_tensor(x) for x in e.values)
        if isinstance(e, ast.IfExp):
            return self.is_tensor(e.body) or self.is_tensor(e.orelse)
        return False


_FN = (ast.FunctionDef, ast.AsyncFunctionDef)


def _own_nodes(fn):
    """The nodes of a function body, not descending into nested defs."""
    stack = list(fn.body)
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if not isinstance(child, (*_FN, ast.ClassDef, ast.Lambda)):
                stack.append(child)


def _is_device_test(test) -> bool:
    """True when every name the test reads is the root of a ``.device`` /
    ``.is_cuda`` / ``.is_cpu`` chain: the choice is the tensors' device."""
    ok_names = set()
    found = False
    for node in ast.walk(test):
        if isinstance(node, ast.Attribute) and node.attr in _DEVICE_ATTRS:
            found = True
            ok_names.update(id(n) for n in ast.walk(node) if isinstance(n, ast.Name))
    names = [n for n in ast.walk(test) if isinstance(n, ast.Name)]
    return found and all(id(n) in ok_names for n in names)


def _calls_plain(nodes) -> str | None:
    for stmt in nodes:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call):
                tail = _tail(node.func) or ""
                if tail.endswith(_PLAIN_SUFFIXES) or tail == "plain":
                    return tail
    return None


def _calls_launch(nodes) -> bool:
    return any(isinstance(n, ast.Call) and _dotted(n.func) in ("build.launch", "launch")
               for stmt in nodes for n in ast.walk(stmt))


def _key_names(expr, fn) -> list[str]:
    """The names a key expression reads: ``Name`` loads that are neither a
    called function nor bound by a comprehension inside it; a name bound in
    ``fn`` to a ``dict(k=...)`` reads as its keyword names."""
    bound = {n.id for c in ast.walk(expr) if isinstance(c, ast.comprehension)
             for n in ast.walk(c.target) if isinstance(n, ast.Name)}
    called = {id(c.func) for c in ast.walk(expr) if isinstance(c, ast.Call)}
    dicts = {}
    if fn is not None:
        for node in _own_nodes(fn):
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Call) and _tail(node.value.func) == "dict"):
                dicts[node.targets[0].id] = [k.arg for k in node.value.keywords if k.arg]
    out = []
    for n in ast.walk(expr):
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load) and id(n) not in called \
                and n.id not in bound:
            out.extend(dicts.get(n.id, [n.id]))
    return out


class _Visitor(ast.NodeVisitor):
    def __init__(self, path: str, allowlist: dict[str, str], hot: frozenset[str],
                 tensor_funcs: set[str], host_funcs: set[str]):
        self.path = path
        self.allow = allowlist
        self.hot = hot
        self.tensor_funcs = tensor_funcs
        self.host_funcs = host_funcs
        self.collapsed: set[int] = set()  # .cpu() calls reported with their .numpy()
        self.findings: list[Finding] = []
        self.stack: list = []  # enclosing FunctionDef nodes
        p = PurePosixPath(path)
        rel = path.removeprefix(PACKAGE_DIR + "/")
        self.rel = rel
        self.in_obs = "obs" in p.parts
        self.in_kernels = "kernels" in p.parts
        self.exempt_seams = "launch" in p.parts or "analysis" in p.parts
        self.imports_capture = False
        self.types: list[_Types] = []

    # ---------------------------------------------------------------- emit
    def _emit(self, code, node, message, detail):
        f = Finding(
            code=code, path=self.path, line=getattr(node, "lineno", 0), message=message,
            context=self.stack[-1].name if self.stack else "<module>", detail=detail,
        )
        if f.key not in self.allow:
            self.findings.append(f)

    def _hot(self) -> bool:
        return any(f"{self.rel}::{fn.name}" in self.hot for fn in self.stack)

    # ------------------------------------------------------------ functions
    def visit_FunctionDef(self, node):
        self._function(node)

    def visit_AsyncFunctionDef(self, node):
        self._function(node)

    def _function(self, node):
        self._check_decorators(node)
        self.stack.append(node)
        self.types.append(_Types(node, self.tensor_funcs, self.host_funcs))
        self.generic_visit(node)
        self.types.pop()
        self.stack.pop()

    def _check_decorators(self, node):
        for dec in node.decorator_list:
            tail = _tail(dec.func if isinstance(dec, ast.Call) else dec)
            if tail == "cache":
                self._emit(RPR005, dec, f"`{node.name}`: functools.cache is an unbounded cache "
                           "with no stated size — use lru_cache(maxsize=...)", "cache-maxsize")
            elif tail == "lru_cache" and not self._literal_maxsize(dec):
                self._emit(RPR005, dec, f"`{node.name}`: lru_cache without a literal maxsize "
                           "caches 128 entries implicitly — declare maxsize",
                           "lru_cache-maxsize")

    @staticmethod
    def _literal_maxsize(dec) -> bool:
        if not isinstance(dec, ast.Call):
            return False
        vals = list(dec.args[:1]) + [k.value for k in dec.keywords if k.arg == "maxsize"]
        return bool(vals) and all(isinstance(v, ast.Constant) for v in vals)

    # --------------------------------------------------------------- RPR004
    def visit_If(self, node):
        self._plain_choice(node, node.test, node.body + node.orelse)
        self.generic_visit(node)

    def visit_IfExp(self, node):
        self._plain_choice(node, node.test, [node.body, node.orelse])
        self.generic_visit(node)

    def _plain_choice(self, node, test, branches):
        if not self.in_kernels:
            return
        plain = _calls_plain(branches)
        if plain and not _is_device_test(test):
            self._emit(RPR004, node, f"the choice of `{plain}` reads `{ast.unparse(test)}`, "
                       "not the tensors' device alone — a wrapper runs its kernel for CUDA "
                       "tensors and its plain version for CPU ones, nothing else",
                       f"plain-choice:{plain}")

    def visit_Try(self, node):
        if self.in_kernels and _calls_launch(node.body):
            for h in node.handlers:
                plain = _calls_plain(h.body)
                if plain:
                    self._emit(RPR004, h, f"a failed kernel launch falls back to `{plain}` — "
                               "a fallback hides the kernel; let the launch raise",
                               f"fallback:{plain}")
        self.generic_visit(node)

    visit_TryStar = visit_Try

    # ---------------------------------------------------------------- calls
    def visit_Import(self, node):
        for a in node.names:
            if a.name.endswith("capture"):
                self.imports_capture = True
        self.generic_visit(node)

    def visit_ImportFrom(self, node):
        if (node.module or "").endswith("capture") or any(a.name == "capture"
                                                          for a in node.names):
            self.imports_capture = True
        for alias in node.names:
            if node.module == "time" and alias.name == "perf_counter" and not self.in_obs:
                self._emit(RPR003, node, "importing perf_counter outside src/repro_torch/obs "
                           "— use the obs clocks/spans", "perf_counter-import")
        self.generic_visit(node)

    def visit_Assign(self, node):
        if (self.imports_capture and self.stack and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name) and node.targets[0].id == "key"
                and isinstance(node.value, (ast.Tuple, ast.BinOp))):
            self._key_fields(node.value)
        self.generic_visit(node)

    def _key_fields(self, expr):
        for name in dict.fromkeys(_key_names(expr, self.stack[-1] if self.stack else None)):
            if name not in STATIC_KEY_ALLOWLIST:
                self._emit(RPR005, expr, f"capture key field `{name}` is not in "
                           "STATIC_KEY_ALLOWLIST — a new key field is a new recording axis "
                           "(an explicit opt-in)", f"capture-key:{name}")

    def visit_Call(self, node):
        tail = _tail(node.func)
        dotted = _dotted(node.func) or ""

        if tail == "lru_cache" and not self._literal_maxsize(node) \
                and not any(node is d for fn in self.stack for d in fn.decorator_list):
            self._emit(RPR005, node, "lru_cache() without a literal maxsize caches 128 entries "
                       "implicitly — declare maxsize", "lru_cache-maxsize")
        if dotted == "capture.run" and node.args:
            self._key_fields(node.args[0])

        sync = self._sync(node, tail, dotted)
        if sync:
            if self._hot():
                self._emit(RPR001, node, f"`{sync}` on the per-chunk path forces a host sync "
                           "every chunk (or breaks a CUDA-graph capture) — hoist it out",
                           sync)
            elif not self.exempt_seams:
                self._emit(RPR002, node, f"host sync `{sync}` in library code — every seam "
                           "must be named in analysis.rules.ALLOWLIST with a justification",
                           sync)

        if tail == "perf_counter" and not self.in_obs:
            self._emit(RPR003, node, "time.perf_counter outside src/repro_torch/obs — use the "
                       "obs clocks/spans (the one timing seam) so tests can inject time",
                       "perf_counter")
        self.generic_visit(node)

    def _sync(self, node, tail, dotted) -> str | None:
        types = self.types[-1] if self.types else _Types(None, self.tensor_funcs)
        method = isinstance(node.func, ast.Attribute)
        if method and tail in ("item", "tolist", "cpu", "numpy") and not node.args:
            recv = node.func.value
            if id(node) in self.collapsed or types.is_host(recv):
                return None
            if tail == "numpy" and isinstance(recv, ast.Call) and _tail(recv.func) == "cpu":
                # the idiomatic pair is one seam: a device→host copy
                self.collapsed.add(id(recv))
                return ".cpu().numpy()"
            return f".{tail}()"
        if dotted == "torch.nonzero" or (method and tail == "nonzero"
                                         and not dotted.startswith(_HOST_ROOTS)
                                         and not types.is_host(node.func.value)):
            return "nonzero"
        if dotted == "torch.equal":
            return "torch.equal"
        if dotted == "torch.cuda.synchronize":
            return "torch.cuda.synchronize"
        if method and tail == "synchronize":
            return ".synchronize()"
        if isinstance(node.func, ast.Name) and node.func.id in ("int", "float", "bool") \
                and len(node.args) == 1 and types.is_tensor(node.args[0]):
            return f"{node.func.id}()"
        return None


def check_source(src: str, path: str, allowlist: dict[str, str] | None = None,
                 hot: frozenset[str] | None = None, tensor_funcs: set[str] | None = None,
                 host_funcs: set[str] | None = None) -> list[Finding]:
    """Run every Layer-1 rule over one module's source text. ``path`` is the
    repo-relative posix path and decides scope (obs/kernels/launch/analysis
    and the HOT table's module names); ``tensor_funcs`` / ``host_funcs``
    name functions known to return tensors / numpy arrays (this module's
    annotated ones are added)."""
    tree = ast.parse(src)
    v = _Visitor(path, ALLOWLIST if allowlist is None else allowlist,
                 HOT if hot is None else hot,
                 annotated_functions(tree, "Tensor") | set(tensor_funcs or ()),
                 annotated_functions(tree, "ndarray") | set(host_funcs or ()))
    v.visit(tree)
    return v.findings


def _files(root: Path, subdir: str) -> list[Path]:
    return [f for f in sorted((root / subdir).rglob("*.py")) if "__pycache__" not in f.parts]


def check_tree(repo_root, subdir: str = PACKAGE_DIR,
               allowlist: dict[str, str] | None = None) -> list[Finding]:
    """Sweep every .py under ``repo_root/subdir`` (the port by default)."""
    root = Path(repo_root)
    files = _files(root, subdir)
    trees = [ast.parse(f.read_text()) for f in files]
    tensor_funcs = set().union(*(annotated_functions(t, "Tensor") for t in trees))
    host_funcs = set().union(*(annotated_functions(t, "ndarray") for t in trees))
    out: list[Finding] = []
    for f in files:
        rel = f.resolve().relative_to(root.resolve()).as_posix()
        out.extend(check_source(f.read_text(), rel, allowlist, tensor_funcs=tensor_funcs,
                                host_funcs=host_funcs))
    return out


def seam_functions(allowlist: dict[str, str] | None = None) -> set[str]:
    """``path::function`` of every allowlisted RPR002 seam: where Layer 2
    counts a sync at run time as a named seam instead of a finding."""
    allow = ALLOWLIST if allowlist is None else allowlist
    return {k.split(" ", 1)[1].rsplit("::", 1)[0] for k in allow if k.startswith("RPR002 ")}
