"""Layer 3 — checks of the CUDA kernels on the card (``RPR2xx``).

The counterpart of ``src/repro/analysis/pallas.py``, which walks Pallas
BlockSpecs statically; a CUDA kernel has no such spec, so these checks run
each kernel entry on the card at a small shape:

  RPR201  output coverage: each entry runs twice with its allocations
          routed to a private pool of PyTorch's caching allocator poisoned
          with 0xFF and then 0x00 bytes; the two results must be bitwise
          equal (a cell the kernel never writes keeps the poison) and equal
          to the plain version. The check shows that the poison reached
          every output's storage (its address range lies in a poisoned
          block) and fails when it cannot.
  RPR202  repeatability: two more launches on the same inputs (outside
          the poisoned pool) are bitwise equal (the race counterpart of the
          reference's revisit hazard).
  RPR203  resources, from the build's ``-Xptxas -v`` report
          (``build.Built.ptxas``): for each entry function, registers ×
          declared threads a block ≤ 65 536, static plus declared dynamic
          shared memory ≤ the card's per-block limit (above 48 KiB only
          where the launcher sets the attribute), and no spill bytes unless
          the kernel's row of :data:`RESOURCES` gives the reason.

It also holds the census of a recorded program's CUDA graphs
(:func:`graph_kernels`), which ``chip_smoke.py`` and Layer 2's ``pc_scan``
entry read. Asked to run without a card, Layer 3 raises: it never skips.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Callable

import torch

from .findings import Finding, register_rule

RPR201 = register_rule("RPR201", "kernel output cell left unwritten (poisoned-allocator runs)")
RPR202 = register_rule("RPR202", "two launches on the same inputs differ")
RPR203 = register_rule("RPR203", "kernel registers, shared memory or spills over the budget")

CSRC = "src/repro_torch/csrc"
REGS_PER_BLOCK = 65_536
DEFAULT_SMEM = 48 * 1024  # per block without the opt-in attribute
OPTIN_SMEM = 227 * 1024  # the H100's per-block opt-in limit
BAND = 1e-4  # the decision band of chip_smoke.py: τ ± 1e-4

# ------------------------------------------------------------ graph census
#: the hand kernels by (a part of) their symbol, under the names they are
#: counted by; PyTorch's own reduce_kernel lives in at::native
KERNEL_NAMES = (("level0_kernel", "level0"), ("level1_kernel", "level1"), ("gsq_kernel", "gsq"),
                ("syrk_kernel", "corr"), ("reduce_kernel", "corr"), ("cholinv_kernel", "cholinv"),
                ("cisweep_kernel", "cisweep"), ("CholinvMath", "skernel"), ("SgridMath", "sgrid"))


def kernel_label(symbol: str) -> str | None:
    """The ``build.LAUNCHES`` name of a hand kernel's (mangled or plain)
    symbol, None for any other kernel."""
    if "at::" in symbol or "2at6native" in symbol:
        return None
    return next((name for part, name in KERNEL_NAMES if part in symbol), None)


def _ok(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed with CUresult {rc}")


def graph_kernels(prog) -> tuple[dict, int]:
    """(the hand kernels among a recorded program's kernel nodes, by
    ``build.LAUNCHES`` name; the count of all its kernel nodes): what one
    replay launches, read from the graphs themselves through the driver
    (``cuGraphGetNodes``, ``cuGraphNodeGetType``,
    ``cuGraphKernelNodeGetParams``, ``cuFuncGetName``)."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    get_params = getattr(cu, "cuGraphKernelNodeGetParams_v2", cu.cuGraphKernelNodeGetParams)
    labels, census, total = {}, {}, 0
    for g in prog.graphs:
        handle = ctypes.c_void_p(g.raw_cuda_graph())
        n = ctypes.c_size_t(0)
        _ok(cu.cuGraphGetNodes(handle, None, ctypes.byref(n)), "cuGraphGetNodes")
        nodes = (ctypes.c_void_p * n.value)()
        _ok(cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)), "cuGraphGetNodes")
        for node in nodes:
            kind = ctypes.c_int(-1)
            _ok(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
                "cuGraphNodeGetType")
            if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
                continue
            total += 1
            params = (ctypes.c_byte * 128)()  # CUDA_KERNEL_NODE_PARAMS_v2 and room
            _ok(get_params(ctypes.c_void_p(node), params), "cuGraphKernelNodeGetParams")
            func = ctypes.c_void_p.from_buffer(params, 0).value
            kern = ctypes.c_void_p.from_buffer(params, 56).value  # the v2 struct's CUkernel
            key = func or kern
            if key not in labels:
                name = ctypes.c_char_p()
                rc = (cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(func)) if func
                      else cu.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(kern)))
                _ok(rc, "the name of a kernel node")
                labels[key] = kernel_label(name.value.decode())
            if labels[key] is not None:
                census[labels[key]] = census.get(labels[key], 0) + 1
    return census, total


# ------------------------------------------------------------------ RPR203
@dataclass(frozen=True)
class Resource:
    """The launch configuration of one kernel function, as its launcher
    (``launcher``: the ``<<<…>>>`` line in csrc) sets it. ``dyn_smem``
    maps the template arguments to the dynamic shared-memory bytes, or is
    None where the launcher sizes it at run time and sets the opt-in
    attribute itself above 48 KiB; ``spills`` gives the reason a spill is
    accepted (none is)."""

    kernel: str  # build.LAUNCHES name
    match: str  # a part of the mangled symbol
    threads: int  # the most threads a block the launcher asks for
    dyn_smem: Callable | int | None
    opt_in: bool  # the launcher sets cudaFuncAttributeMaxDynamicSharedMemorySize
    launcher: str
    spills: str = ""


def _corr_smem(t) -> int:
    tile = t[0]
    return 3 * 2 * (32 if tile == 128 else 16) * tile * 4  # corr.cu smem_bytes<T>()


RESOURCES = (
    Resource("corr", "syrk_kernel", 256, _corr_smem, True, f"{CSRC}/corr.cu:319"),
    Resource("corr", "reduce_kernel", 256, 0, False, f"{CSRC}/corr.cu:347"),
    Resource("level0", "level0_kernel", 128, None, True, f"{CSRC}/level0.cu:166"),
    Resource("level1", "atanh_window_kernel", 256, 0, False, f"{CSRC}/level1.cu:147"),
    Resource("level1", "level1_kernel", 256, 0, False, f"{CSRC}/level1.cu:139"),
    Resource("cholinv", "cholinv_kernel", 128, 0, False, f"{CSRC}/cholinv.cu:57"),
    Resource("cisweep", "cisweep_kernel", 256, lambda t: 64 * (t[0] * t[0] + t[0] + 1) * 4,
             False, f"{CSRC}/cisweep.cu:81"),
    Resource("gsq", "gsq_kernel", 256, None, True, f"{CSRC}/gsq.cu:173"),
    Resource("skernel", "CholinvMath", 128, 0, False, f"{CSRC}/sweep.cuh:230"),
    Resource("sgrid", "SgridMath", 128, 0, False, f"{CSRC}/sweep.cuh:230"),
)

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PROPS = re.compile(r"Function properties for (\S+)")
_STACK = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")


def parse_ptxas(text: str) -> list[dict]:
    """Every entry function of a ``-Xptxas -v`` report (with the build's
    ``== file.cu`` separators): source, symbol, registers, static shared
    memory, stack frame and spill bytes."""
    rows: dict[str, dict] = {}
    source, current, props = "", None, None
    for line in text.splitlines():
        s = line.strip()
        if s.startswith("== "):
            source = s[3:].strip()
            continue
        m = _ENTRY.search(s)
        if m:
            current = m.group(1)
            rows.setdefault(current, dict(source=source, symbol=current, registers=0, smem=0,
                                          stack=0, spill_stores=0, spill_loads=0))
            continue
        m = _PROPS.search(s)
        if m:
            props = m.group(1)
            continue
        m = _STACK.search(s)
        if m and props in rows:
            rows[props].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
            continue
        m = _USED.search(s)
        if m and current in rows:
            rows[current]["registers"] = int(m.group(1))
            sm = _SMEM.search(s)
            rows[current]["smem"] = int(sm.group(1)) if sm else 0
    return list(rows.values())


def _template_ints(symbol: str, match: str) -> tuple[int, ...]:
    """The leading integer template arguments after ``match`` in an
    Itanium-mangled symbol (``cholinv_kernelILi8EE`` → (8,))."""
    tail = symbol.split(match, 1)[-1]
    out = []
    for m in re.finditer(r"Li(\d+)E", tail[: tail.find("EE") + 2] if "EE" in tail else tail):
        out.append(int(m.group(1)))
    return tuple(out)


def resource_findings(ptxas: str, *, optin: int = OPTIN_SMEM, default: int = DEFAULT_SMEM,
                      regs_per_block: int = REGS_PER_BLOCK,
                      resources=RESOURCES) -> tuple[list[Finding], list[dict]]:
    """RPR203 over a ptxas report: (findings, one row per entry function)."""
    out, rows = [], []
    for fn in parse_ptxas(ptxas):
        res = next((r for r in resources if r.match in fn["symbol"]), None)
        path = f"{CSRC}/{fn['source']}" if fn["source"] else CSRC
        if res is None:
            out.append(Finding(code=RPR203, path=path, line=0, context=fn["symbol"],
                               message=f"kernel `{fn['symbol']}` has no row in "
                                       "cuda.RESOURCES (threads, shared memory, launcher)",
                               detail="undeclared"))
            continue
        targs = _template_ints(fn["symbol"], res.match)
        name = res.match + (f"<{','.join(map(str, targs))}>" if targs else "")
        dyn = res.dyn_smem(targs) if callable(res.dyn_smem) else res.dyn_smem
        limit = optin if res.opt_in else default
        regs = fn["registers"] * res.threads
        smem = fn["smem"] + (dyn or 0)
        spill = fn["spill_stores"] + fn["spill_loads"]
        row = dict(kernel=res.kernel, function=name, source=fn["source"],
                   registers=fn["registers"], threads=res.threads, block_registers=regs,
                   stack=fn["stack"], spill_stores=fn["spill_stores"],
                   spill_loads=fn["spill_loads"], static_smem=fn["smem"],
                   dyn_smem="runtime" if dyn is None else dyn, smem_limit=limit,
                   launcher=res.launcher)
        rows.append(row)
        if regs > regs_per_block:
            out.append(Finding(code=RPR203, path=path, line=0, context=name,
                               message=f"{name}: {fn['registers']} registers × {res.threads} "
                                       f"threads = {regs} > {regs_per_block} a block",
                               detail="registers"))
        if smem > limit:
            out.append(Finding(code=RPR203, path=path, line=0, context=name,
                               message=f"{name}: {fn['smem']} B static + {dyn or 0} B dynamic "
                                       f"shared memory > the {limit} B a block"
                                       + ("" if res.opt_in else " without the opt-in"),
                               detail="smem"))
        if spill and not res.spills:
            out.append(Finding(code=RPR203, path=path, line=0, context=name,
                               message=f"{name} spills {fn['spill_stores']} B stores / "
                                       f"{fn['spill_loads']} B loads — fix it or give the "
                                       "reason in its RESOURCES row",
                               detail="spills"))
    return out, rows


# --------------------------------------------------------------- RPR201/202
def poisoned_run(kernel, pattern: int, device: torch.device,
                 sizes=(1 << 20,) * 8 + (64 << 20,) * 2):
    """``kernel()`` with every allocation it makes routed to a fresh private
    pool of PyTorch's caching allocator (``torch.cuda.MemPool``) that holds
    nothing but blocks filled with the byte ``pattern`` (small-pool and
    large-pool sizes, freed before the call). Returns (copies of the
    outputs, whether every output's storage lies in a poisoned block): an
    output outside them came from memory the poison never reached."""
    pool = torch.cuda.MemPool()
    index = torch.cuda.current_device() if device.index is None else device.index
    with torch.cuda.use_mem_pool(pool, index):
        soak = [torch.empty(n, dtype=torch.uint8, device=device) for n in sizes]
        for t in soak:
            t.fill_(pattern)
        ranges = [(t.data_ptr(), t.data_ptr() + t.numel()) for t in soak]
        del soak, t
        outs = _as_tuple(kernel())
    torch.cuda.synchronize(device)
    landed = all(_in_ranges(o, ranges) for o in outs)
    return tuple(o.clone() for o in outs), landed


def _in_ranges(t: torch.Tensor, ranges) -> bool:
    """True when the tensor's bytes lie in the poisoned ranges (adjacent
    ranges merged: freed neighbours coalesce into one block)."""
    merged: list[list[int]] = []
    for a, b in sorted(ranges):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    lo = t.data_ptr()
    hi = lo + t.numel() * t.element_size()
    return t.numel() == 0 or any(a <= lo and hi <= b for a, b in merged)


@dataclass(frozen=True)
class KernelCase:
    """One kernel entry at a small shape: ``build(dev)`` gives (kernel(),
    plain(tau_shift)) closures over the same inputs on the card, and the
    comparison with the plain version: "exact", ("close", rtol, atol) or
    "band" (cells where the plain version at τ − 1e-4 and τ + 1e-4 agree
    must equal it)."""

    name: str
    kernel: str
    path: str
    build: Callable
    compare: object = "exact"


def _as_tuple(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def kernel_cases() -> list[KernelCase]:
    """The 8 ``build.LAUNCHES`` kernels' entries: corr (direct and split-K),
    level0's two entries, level1, the gathered cholinv and cisweep, gsq,
    sgrid's gathered and fused entries, and skernel."""
    from repro_torch.core import levels as L
    from repro_torch.kernels import cholinv as CH
    from repro_torch.kernels import cisweep as CS
    from repro_torch.kernels import corr as CO
    from repro_torch.kernels import gsq as G
    from repro_torch.kernels import level0 as L0
    from repro_torch.kernels import level1 as L1
    from repro_torch.kernels import ops
    from repro_torch.kernels import sgrid as SG
    from repro_torch.kernels import skernel as SK

    from .dispatch import _gauss_chunk_args

    tau = 0.05

    def chunk(dev):
        c, adj, sep, compact, counts, t0, _, kw = _gauss_chunk_args(dev, n=64, npr=16,
                                                                    n_chunk=32)
        rows = torch.arange(compact.shape[0], dtype=torch.int32, device=dev)
        return c, adj, compact, counts, rows, t0, kw

    def gathered(dev):
        c, adj, compact, counts, rows, t0, kw = chunk(dev)
        ranks = L._chunk_ranks(t0, kw["n_chunk"])
        return L.gather_s(c, adj, compact, counts, rows, ranks, ell=kw["ell"],
                          n_max=kw["n_max"])

    def corr(m):
        def build(dev):
            gen = torch.Generator().manual_seed(m)
            xn = ops.standardize(torch.randn((m, 200), generator=gen)).to(dev).contiguous()
            return lambda: CO.corr_matmul(xn), lambda s=0.0: CO.corr_matmul_plain(xn)
        return build

    def level0(span):
        def build(dev):
            c = chunk(dev)[0]
            if span:
                return (lambda: L0.level0_span(c, tau, 8),
                        lambda s=0.0: L.level0_span(c, tau + s, 8))
            return lambda: L0.level0_kernel(c, tau), lambda s=0.0: L.level0(c, tau + s)
        return build

    def level1(dev):
        c, adj, *_ = chunk(dev)
        return (lambda: L1.level1_dense_kernel(c, adj, tau),
                lambda s=0.0: L1.level1_dense_plain(c, adj, tau + s))

    def flat(dev):
        m2, ci_s, cj_s, cij, mask, _ = gathered(dev)
        n_l, t_len, npr = mask.shape
        b, ell = n_l * t_len, m2.shape[-1]
        return (m2.reshape(b, ell, ell).contiguous(), ci_s.reshape(b, ell).contiguous(),
                cj_s.reshape(b, npr, ell).contiguous(), cij.reshape(b, npr).contiguous(),
                mask.reshape(b, npr).contiguous())

    def cholinv(dev):
        m2, ci, *_ = flat(dev)
        return lambda: CH.cholinv(m2, ci), lambda s=0.0: CH.cholinv_plain(m2, ci)

    def cisweep(dev):
        m2, ci, cj, cij, mask = flat(dev)
        g, u, var = CH.cholinv_plain(m2, ci)
        return (lambda: CS.cisweep(g, u, var, cj, cij, mask, tau),
                lambda s=0.0: CS.cisweep_plain(g, u, var, cj, cij, mask, tau + s))

    def gsq(dev):
        gen = torch.Generator().manual_seed(1)
        jc = torch.randint(0, 12, (96, 300), generator=gen, dtype=torch.int32).to(dev)
        return (lambda: G.gsq_cells(jc, r=2, q=3), lambda s=0.0: G.gsq_ref(jc, r=2, q=3))

    def sgrid(dev):
        m2, ci_s, cj_s, cij, mask, s_ids = gathered(dev)
        return (lambda: SG.sgrid(m2, ci_s, cj_s, cij, mask, s_ids, tau),
                lambda s=0.0: SG.sgrid_plain(m2, ci_s, cj_s, cij, mask, s_ids, tau + s))

    def fused(kind):
        def build(dev):
            c, adj, compact, counts, rows, t0, kw = chunk(dev)
            if kind == "skernel":
                return (lambda: SK.skernel_fused(c, adj, compact, counts, rows, t0, tau, **kw),
                        lambda s=0.0: SK.skernel_plain(c, adj, compact, counts, rows, t0,
                                                       tau + s, **kw))

            def plain(s=0.0):
                ranks = L._chunk_ranks(t0, kw["n_chunk"])
                s_ids, valid = L.plan_sets(compact, counts, ranks, ell=kw["ell"],
                                           n_max=kw["n_max"], n=c.shape[0])
                m2, ci_s, cj_s, cij, mask = L.gather_sets(c, adj, compact, rows, s_ids, valid)
                return SG.sgrid_plain(m2, ci_s, cj_s, cij, mask, s_ids, tau + s)

            return lambda: SG.sgrid_fused(c, adj, compact, counts, rows, t0, tau, **kw), plain
        return build

    k = "src/repro_torch/kernels"
    close = ("close", 1e-5, 2e-6)
    return [
        KernelCase("corr_matmul direct", "corr", f"{k}/corr.py", corr(256), close),
        KernelCase("corr_matmul split-K", "corr", f"{k}/corr.py", corr(1024), close),
        KernelCase("level0_kernel", "level0", f"{k}/level0.py", level0(False)),
        KernelCase("level0_span", "level0", f"{k}/level0.py", level0(True)),
        KernelCase("level1_dense_kernel", "level1", f"{k}/level1.py", level1, "band"),
        KernelCase("cholinv", "cholinv", f"{k}/cholinv.py", cholinv, ("close", 1e-5, 1e-6)),
        KernelCase("cisweep", "cisweep", f"{k}/cisweep.py", cisweep, "band"),
        KernelCase("gsq_cells", "gsq", f"{k}/gsq.py", gsq),
        KernelCase("sgrid (gathered)", "sgrid", f"{k}/sgrid.py", sgrid, "band"),
        KernelCase("sgrid_fused", "sgrid", f"{k}/sgrid.py", fused("sgrid"), "band"),
        KernelCase("skernel_fused", "skernel", f"{k}/skernel.py", fused("skernel"), "band"),
    ]


def _equal(a, b) -> bool:
    return len(a) == len(b) and all(x.shape == y.shape and torch.equal(x, y)
                                    for x, y in zip(a, b))


def plain_agrees(got, plain, compare) -> bool:
    """The kernel's outputs against its plain version (``plain(shift)``)."""
    want = _as_tuple(plain(0.0))
    if compare == "exact":
        return _equal(got, want)
    if compare == "band":
        lo, hi = _as_tuple(plain(-BAND)), _as_tuple(plain(BAND))
        return all(torch.equal(g[lo_ == hi_], lo_[lo_ == hi_])
                   for g, lo_, hi_ in zip(got, lo, hi))
    _, rtol, atol = compare
    return all(torch.allclose(g, w, rtol=rtol, atol=atol) for g, w in zip(got, want))


def judge_case(case: KernelCase, runs, landed: bool, repeats, plain):
    """RPR201 and RPR202 from what ran: ``runs`` the outputs of the 0xFF-
    and 0x00-poisoned runs, ``landed`` whether the poison reached every
    output (and the kernel launched), ``repeats`` two more launches' outputs,
    ``plain(shift)`` the plain version. At most one finding of each rule,
    its detail the first failed check. Returns (findings, row)."""
    checks = {"poison-missed": landed, "coverage": _equal(runs[0], runs[1]),
              "plain": plain_agrees(runs[0], plain, case.compare)}
    again = _equal(*repeats)
    failed = [k for k, ok in checks.items() if not ok]
    out = []
    if failed:
        why = {"poison-missed": "the poison did not reach every output's storage (or "
                                "nothing launched), so coverage is unproven",
               "coverage": "outputs differ between the 0xFF- and 0x00-poisoned runs — a "
                           "cell is never written",
               "plain": f"outputs differ from the plain version ({case.compare})"}
        out.append(Finding(code=RPR201, path=case.path, line=0, context=case.name,
                           message=f"{case.name}: " + "; ".join(why[k] for k in failed),
                           detail=failed[0]))
    if not again:
        out.append(Finding(code=RPR202, path=case.path, line=0, context=case.name,
                           message=f"{case.name}: two launches on the same inputs differ "
                                   "(a race)", detail="repeat"))
    row = dict(name=case.name, kernel=case.kernel, poison_landed=checks["poison-missed"],
               poison_equal=checks["coverage"], plain=checks["plain"],
               compare=str(case.compare), repeat_equal=again)
    return out, row


def check_case(case: KernelCase, device: torch.device) -> tuple[list[Finding], dict]:
    """RPR201 and RPR202 for one kernel entry on the card."""
    from repro_torch.kernels import build

    kernel, plain = case.build(device)
    kernel()  # warm: the library, cached tables, the opt-in attributes
    runs, landed = [], True
    counted = case.kernel in build.LAUNCHES  # a toy fixture launches no hand kernel
    for pattern in (0xFF, 0x00):
        before = build.LAUNCHES.get(case.kernel, 0)
        outs, ok = poisoned_run(kernel, pattern, device)
        landed = landed and ok and (not counted or build.LAUNCHES[case.kernel] > before)
        runs.append(outs)
    repeats = [tuple(t.clone() for t in _as_tuple(kernel())) for _ in range(2)]
    torch.cuda.synchronize(device)
    return judge_case(case, runs, landed, repeats, plain)


def require_card(device) -> torch.device:
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("analysis layer 3 runs the CUDA kernels on the card: it needs a "
                           f"CUDA device, got {device} (available: "
                           f"{torch.cuda.is_available()})")
    return device


def all_findings(device=None):
    """Every Layer-3 check on the card: (findings, {table: rows})."""
    from repro_torch.kernels import build

    device = require_card(device)
    out, cases = [], []
    for case in kernel_cases():
        fs, row = check_case(case, device)
        out += fs
        cases.append(row)
    props = torch.cuda.get_device_properties(device)
    optin = getattr(props, "shared_memory_per_block_optin", OPTIN_SMEM) or OPTIN_SMEM
    fs, resources = resource_findings(build.library().ptxas, optin=optin)
    out += fs
    return out, {"kernels": cases, "resources": resources}


__all__ = [
    "graph_kernels", "kernel_label", "KERNEL_NAMES", "parse_ptxas", "resource_findings",
    "RESOURCES", "Resource", "poisoned_run", "kernel_cases", "check_case", "judge_case",
    "all_findings",
    "plain_agrees", "require_card",
]
