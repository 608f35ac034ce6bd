"""Fixed-shape programs recorded once as CUDA graphs and replayed.

The PyTorch counterpart of the reference's ``jax.jit`` over the batch
programs (``src/repro/batch/scan_pc.py``'s ``_build`` and
``_build_level``): :func:`run` records ``fn(*inputs)`` the first time a
static key is seen and replays the recording on every later call with
the same key. A program's key names everything its launches depend on
besides the input tensors' contents: shapes, the width schedule, the
budget, the jitter, the device and the τ values, which the kernels take
as launch arguments (a replay cannot change them).

Recording follows PyTorch's CUDA-graph notes: one eager run on a side
stream first (it fills the caches the program reads, such as the binomial
tables of ``levels._jtable``), then the capture, then a first replay whose
outputs must equal the eager run's bitwise. A capture that fails means
the program synchronises with the host somewhere; that is raised, never
run eagerly instead.

A program is recorded as a sequence of graphs, captured in turn into one
memory pool and replayed in the same order with no host sync between
them. A program marks the points between its steps with :func:`boundary`;
at such a point the recording ends the current graph once it holds about
``SEGMENT_NODES`` nodes (judged by the previous graph's nodes a step)
and begins the next. Each graph is counted (its nodes, through the
driver's ``cuGraphGetNodes``) before it is instantiated, and one with
more than ``MAX_NODES`` nodes is refused with :class:`GraphTooLarge`.
``MAX_NODES`` is the largest graph of the port's kind whose repeated
replays were shown to run on the H100; graphs of 3.4·10⁶ and 4.5·10⁶
such nodes faulted or crashed there (``scripts/scan_graph_probe.py``).

Each recording and each eviction is logged (:func:`log`): a serving
stream records one program a (slot size, τ vector, schedule), and the
log says how many it recorded, their seconds and how many the LRU
dropped.

Launch counts stay true: the kernel wrappers count in Python
(``kernels.build.LAUNCHES``), which a replay does not run, so each
program records what its capture counted, takes it back (a capture
launches nothing) and adds it at every replay. A program's first call
thus counts two runs (the eager run and the first replay), later calls
one.
"""
from __future__ import annotations

import ctypes
import functools
import time
from collections import OrderedDict

import torch

from ..kernels import build

#: programs kept at once; each holds its graphs' memory pool, and the
#: least recently used one is dropped first
MAX_PROGRAMS = 16
_PROGRAMS: OrderedDict = OrderedDict()
#: the most nodes one graph may hold
MAX_NODES = 1_713_806
#: the nodes a graph is cut at: the first graph ends at its FIRST_SPAN-th
#: boundary, each later one after SEGMENT_NODES at its predecessor's nodes
#: a step
SEGMENT_NODES = 500_000
FIRST_SPAN = 16
_RECORDING = None  # the Program being captured
#: since the last ``reset_log``: one (name, record_s, nodes) a recording,
#: and the programs dropped to keep MAX_PROGRAMS
_LOG = {"recorded": [], "evicted": 0}


class GraphTooLarge(RuntimeError):
    """A graph between two boundaries holds more nodes than ``MAX_NODES``."""


@functools.lru_cache(maxsize=1)
def _libcuda():
    return ctypes.CDLL("libcuda.so.1")


def graph_nodes(graph: torch.cuda.CUDAGraph) -> int:
    """Nodes of a graph captured with ``keep_graph=True``."""
    count = ctypes.c_size_t(0)
    rc = _libcuda().cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()), None,
                                    ctypes.byref(count))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes failed with CUresult {rc}")
    return count.value


def boundary() -> None:
    """A point between two steps of a program, where its recording may end
    one graph and begin the next; nothing outside a recording."""
    if _RECORDING is not None:
        _RECORDING._boundary()


class Program:
    """``fn(*inputs)`` recorded as CUDA graphs over private copies of the
    inputs, under its static ``key``. ``keep`` holds tensors the graphs
    read that live outside their pool (cached tables), so that no
    eviction frees them. ``nodes`` lists each graph's node count."""

    def __init__(self, key: tuple, fn, inputs, keep=()):
        global _RECORDING
        self.key = key
        self.keep = tuple(keep)
        name = str(key[0])
        dev = inputs[0].device
        t0 = time.monotonic()
        self.inputs = tuple(t.clone() for t in inputs)
        current = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            warm = tuple(t.clone() for t in fn(*self.inputs))
        current.wait_stream(side)

        before = dict(build.LAUNCHES)
        self.graphs, self.nodes = [], []
        self._pool, self._open, self._steps, self._span = None, None, 0, FIRST_SPAN
        stream = torch.cuda.Stream(dev)
        torch.cuda.synchronize(dev)
        try:
            with torch.cuda.stream(stream):
                self._begin()
                _RECORDING = self
                try:
                    self.outputs = tuple(fn(*self.inputs))
                finally:
                    _RECORDING = None
                self._end()
        except GraphTooLarge:
            self._abort()
            raise
        except RuntimeError as e:
            self._abort()
            raise RuntimeError(f"CUDA-graph capture of {name} failed: its path synchronises "
                               "with the host or copies from it") from e
        finally:
            self.launches = {k: build.LAUNCHES[k] - before[k] for k in before}
            for k, v in self.launches.items():
                build.LAUNCHES[k] -= v
        for g in self.graphs:
            g.instantiate()
        self.first = self.replay()
        if not all(torch.equal(a, b) for a, b in zip(warm, self.first)):
            raise RuntimeError(f"the first replay of {name} differs from its eager run")
        torch.cuda.synchronize(dev)
        self.record_s = time.monotonic() - t0

    def _begin(self) -> None:
        self._open = torch.cuda.CUDAGraph(keep_graph=True)
        self._open.capture_begin(pool=self._pool)
        self._steps = 0

    def _end(self) -> None:
        g, self._open = self._open, None
        g.capture_end()
        self.graphs.append(g)
        if self._pool is None:
            self._pool = g.pool()
        nodes = graph_nodes(g)
        self.nodes.append(nodes)
        if nodes > MAX_NODES:
            raise GraphTooLarge(
                f"a graph of {self.key[0]} holds {nodes} nodes between two boundaries, more "
                f"than the {MAX_NODES} of the largest graph shown to replay "
                "(capture.MAX_NODES): lower max_level or the width, or run a host-loop engine")
        if self._steps:  # the next graph's steps at this one's nodes a step
            self._span = max(1, SEGMENT_NODES * self._steps // max(nodes, 1))

    def _boundary(self) -> None:
        self._steps += 1
        if self._steps >= self._span:
            self._end()
            self._begin()

    def _abort(self) -> None:
        """End a capture cut short and free what was recorded."""
        if self._open is not None:
            try:
                self._open.capture_end()
            except RuntimeError:
                pass
            self.graphs.append(self._open)
            self._open = None
        for g in self.graphs:
            g.reset()
        self.graphs = []

    def launch(self) -> None:
        """Replay every graph in order (no host sync, no count)."""
        for g in self.graphs:
            g.replay()

    def replay(self) -> tuple:
        """Run the graphs on the current inputs; copies of the outputs."""
        self.launch()
        for k, v in self.launches.items():
            build.LAUNCHES[k] += v
        return tuple(t.clone() for t in self.outputs)

    def __call__(self, *inputs) -> tuple:
        for static, given in zip(self.inputs, inputs):
            static.copy_(given)
        return self.replay()


def run(key: tuple, fn, inputs, keep=()) -> tuple:
    """``fn(*inputs)`` through the program cached under ``key``, recorded
    on the first call with that key. ``fn`` returns a tuple of tensors and
    must read nothing but ``inputs`` and what ``key`` pins down."""
    prog = _PROGRAMS.get(key)
    if prog is not None:
        _PROGRAMS.move_to_end(key)
        return prog(*inputs)
    prog = Program(key, fn, inputs, keep)
    _PROGRAMS[key] = prog
    _LOG["recorded"].append((str(key[0]), prog.record_s, sum(prog.nodes)))
    while len(_PROGRAMS) > MAX_PROGRAMS:
        _PROGRAMS.popitem(last=False)
        _LOG["evicted"] += 1
    first, prog.first = prog.first, None
    return first


def programs() -> list:
    """The cached programs, least recently used first."""
    return list(_PROGRAMS.values())


def log() -> dict:
    """{"recorded": [(program name, record seconds, graph nodes), ...],
    "evicted": programs dropped} since the last :func:`reset_log`."""
    return {"recorded": list(_LOG["recorded"]), "evicted": _LOG["evicted"]}


def reset_log() -> None:
    _LOG["recorded"].clear()
    _LOG["evicted"] = 0


def clear() -> None:
    """Drop every cached program and with it its graphs' memory."""
    _PROGRAMS.clear()
