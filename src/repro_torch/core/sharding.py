"""The one device-sharding layer of the port (``src/repro/core/sharding.py``).

Both scaling axes shard over ONE flat mesh, as in the reference:

* the row axis of one large graph: ``core/distributed.py`` shards the
  compacted adjacency (and, with ``shard_c`` / ``shard_sep``, the
  correlation matrix and the sepset tensor) row-wise;
* the batch axis of a many-graph workload: ``batch/`` shards the leading
  B dimension of ``pc_scan_batch``, ``scan_levels_batch`` and
  ``bootstrap_pc``.

One process owns the mesh (the reference is single-controller too). A
:class:`Mesh` is an ordered tuple of ``torch.device``s, repeats allowed:
``("cpu",) * 8`` or ``("cuda:0",) * 4`` are K logical shards on one
device, the counterpart of the reference's
``XLA_FLAGS=--xla_force_host_platform_device_count=K``. A sharded array
is a :class:`Sharded`: the list of its per-shard tensors, each on its
shard's device, with the layout it was placed by (``row_spec``,
``batch_spec`` or ``replicated_spec``). A collective is an explicit copy
between those tensors (``core/distributed.py``).

The LM side's meshes have named axes, as ``jax.make_mesh((2, 2, 2),
("pod", "data", "model"))`` has them: a :class:`NamedMesh` beside the flat
:class:`Mesh`, its ranks in row-major order over the axes, and a
:class:`Spec` a tensor (the reference's ``PartitionSpec``) saying which
axes split each dimension. :func:`shard_named` and :func:`gather_named`
place a tensor on such a mesh and back; ``state.shard_tree`` does it for a
tree. A tensor crosses between the ranks of a named mesh only through
:func:`move`, which :func:`count_seams` records (those rank 0 sends or
receives); :func:`on_rank` marks one rank's work for a counter.

The collectives of an SPMD program over a named mesh (``models/spmd.py``'s
train step) act on one tensor a rank, in rank order, over the ranks that
one :class:`RankSet` drives: :func:`all_gather` (its backward a
reduce-scatter), :func:`reduce_scatter` (its backward an all-gather),
:func:`all_reduce` (Megatron's *g*: its backward the identity on each
rank's gradient) and :func:`copy_to` (Megatron's *f*: the identity, its
backward an all-reduce), each a ``torch.autograd.Function``. Every
crossing is a :func:`move` of its kind, and every sum adds in rank order,
so a program is bitwise repeatable and every rank of a group holds the
same bits. An all-reduce is a reduce-scatter of equal pieces of the
flattened tensor and an all-gather of the summed pieces, each rank moving
2 (n − 1) / n of the tensor each way, as a ring would. On a mesh of
``meta`` devices under :func:`lead_rank_only` a :class:`RankSet` drives
rank 0 alone: the others' tensors are stood in for by rank 0's (every rank
holds blocks of one shape), and the moves rank 0 would make to them are
made all the same, so rank 0's crossings are counted as in a run of every
rank (``launch.dryrun``).
"""
from __future__ import annotations

import contextlib
import functools
import math
from dataclasses import dataclass

import torch

#: The single mesh axis every PC sharding uses (the reference's name).
AXIS = "rows"


class Mesh(tuple):
    """An ordered tuple of ``torch.device``s, one per shard; a device may
    repeat (logical shards). Hashable, so plans may be cached per mesh."""

    def __new__(cls, devices):
        devs = tuple(torch.device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        return super().__new__(cls, devs)

    @property
    def devices(self) -> tuple:
        return tuple(self)

    def distinct(self) -> tuple:
        """The mesh's devices without repeats, in first-seen order: where a
        replicated array keeps one copy each."""
        return tuple(dict.fromkeys(self))

    def __repr__(self) -> str:
        return f"Mesh({', '.join(str(d) for d in self)})"


# --------------------------------------------------------------------------
# mesh construction
# --------------------------------------------------------------------------
def make_mesh(n_devices: int | None = None, devices=None, device=None) -> Mesh:
    """Flat mesh over (a prefix of) the visible devices.

    devices: explicit device list (overrides the rest), e.g.
    ``("cuda:0",) * 4`` or ``("cpu",) * 8``.
    device: "cpu" makes ``n_devices`` (default 1) logical CPU shards; None
    (the port's default, the CUDA card) takes the first ``n_devices``
    visible cards (all by default) and raises with an actionable hint when
    fewer are visible."""
    if devices is not None:
        return Mesh(devices)
    if device is not None and torch.device(device).type == "cpu":
        return Mesh((torch.device("cpu"),) * (1 if n_devices is None else int(n_devices)))
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    want = visible if n_devices is None else int(n_devices)
    if want > visible or want < 1:
        k = max(want, 1)
        raise ValueError(
            f"requested a {k}-device mesh but only {visible} CUDA devices are visible; "
            f"for {k} logical shards on one device pass devices=('cuda:0',) * {k}, or "
            f"device='cpu' (devices=('cpu',) * {k}) for the plain versions on the CPU")
    return Mesh(torch.device("cuda", i) for i in range(want))


def mesh_size(mesh: Mesh) -> int:
    return len(mesh)


# --------------------------------------------------------------------------
# layout descriptors (the reference's NamedSharding specs)
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class Layout:
    """How a global array is placed on a mesh: ``spec`` names the mesh
    axis of each leading dimension (the reference's PartitionSpec), () for
    a fully replicated array."""

    mesh: Mesh
    spec: tuple

    @property
    def replicated(self) -> bool:
        return self.spec == ()

    def __str__(self) -> str:
        return f"Layout(spec={self.spec}, mesh={self.mesh!r})"


def row_spec(mesh: Mesh) -> Layout:
    """Leading axis sharded over the mesh, trailing dims whole: rows of C
    (n_pad, n), the compacted adjacency (n_pad, n′) and the sepset tensor
    (n_pad, n, depth). Shard d holds global rows [d·n_pad/K, (d+1)·n_pad/K)."""
    return Layout(mesh, (AXIS,))


def batch_spec(mesh: Mesh, ndim: int = 3) -> Layout:
    """Leading (batch) axis sharded, trailing dims whole: a (B, n, n) stack."""
    return Layout(mesh, (AXIS,) + (None,) * (ndim - 1))


def replicated_spec(mesh: Mesh) -> Layout:
    """One whole copy on each device of the mesh."""
    return Layout(mesh, ())


class Sharded(list):
    """A global array as its per-shard tensors (one per mesh entry, each on
    that shard's device), with its ``sharding`` (a :class:`Layout`) and
    global ``shape``. Replicated arrays hold one tensor per device, shared
    by the shards that repeat it."""

    def __init__(self, blocks, sharding: Layout, shape):
        super().__init__(blocks)
        self.sharding = sharding
        self.shape = tuple(shape)

    def gather(self, device=None) -> torch.Tensor:
        """The global array on ``device`` (default the first shard's)."""
        dev = self[0].device if device is None else torch.device(device)
        if self.sharding.replicated:
            return self[0].to(dev)
        return torch.cat([b.to(dev) for b in self], dim=0)


# --------------------------------------------------------------------------
# shard-aligned padding
# --------------------------------------------------------------------------
def pad_amount(dim: int, mesh: Mesh) -> int:
    """Rows/graphs of padding that make ``dim`` a shard-count multiple."""
    return (-dim) % mesh_size(mesh)


def per_device_rows(dim: int, mesh: Mesh) -> int:
    """Leading-axis length of one shard's block after padding: a
    row-sharded (n, …) tensor keeps ``per_device_rows(n, mesh) ·
    prod(trailing dims)`` elements a shard."""
    return (dim + pad_amount(dim, mesh)) // mesh_size(mesh)


def pad_leading(x: torch.Tensor, mesh: Mesh, fill=0):
    """Pad the leading axis of x to a shard multiple with ``fill``, at the
    END, so shard-local index k still addresses global index
    ``shard · per_shard + k``. Returns (padded, pad)."""
    pad = pad_amount(x.shape[0], mesh)
    if pad == 0:
        return x, 0
    return torch.cat([x, x.new_full((pad, *x.shape[1:]), fill)]), pad


def unpad_leading(x, pad: int):
    """Drop the trailing pad rows/graphs that :func:`pad_leading` appended."""
    return x if pad == 0 else x[: x.shape[0] - pad]


def _split(x: torch.Tensor, mesh: Mesh, layout: Layout) -> Sharded:
    per = x.shape[0] // mesh_size(mesh)
    return Sharded([x[k * per:(k + 1) * per].to(dev) for k, dev in enumerate(mesh)], layout,
                   x.shape)


def shard_rows(x: torch.Tensor, mesh: Mesh, fill=0):
    """Pad the leading axis to a shard multiple and split it over the mesh:
    (Sharded of (per_device_rows, *trailing) blocks, pad). THE way per-row
    state (compacted adjacency, counts, rows of C, sepset rows) is placed."""
    x, pad = pad_leading(x, mesh, fill=fill)
    return _split(x, mesh, row_spec(mesh)), pad


def shard_batch(x: torch.Tensor, mesh: Mesh, fill=0):
    """Pad the leading batch axis to a shard multiple and split it over the
    mesh. Returns (Sharded, pad)."""
    x, pad = pad_leading(x, mesh, fill=fill)
    return _split(x, mesh, batch_spec(mesh, x.ndim)), pad


def replicate(x: torch.Tensor, mesh: Mesh) -> Sharded:
    """x whole on every device of the mesh: one copy a distinct device,
    shared by the shards that repeat it."""
    copies = {dev: x.to(dev) for dev in mesh.distinct()}
    return Sharded([copies[dev] for dev in mesh], replicated_spec(mesh), x.shape)


# --------------------------------------------------------------------------
# named meshes: the LM side's (pod, data, model) layouts
# --------------------------------------------------------------------------
class Spec(tuple):
    """A per-dimension partition spec (the reference's ``PartitionSpec``):
    one entry a dimension, None (whole), an axis name, or a tuple of axis
    names (the dimension split over their product, the first name
    outermost). A leaf of ``repro_torch.tree``'s trees, not a container."""

    __tree_leaf__ = True

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def spec_axes(entry) -> tuple:
    """The axis names of one spec entry (None: none)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class NamedMesh:
    """A mesh with named axes, the counterpart of ``jax.make_mesh(shape,
    axes)``: ``shape`` maps each axis name to its size (in order), and
    ``devices`` holds one ``torch.device`` a rank, in row-major order over
    the axes (a device may repeat: logical shards). With ``devices`` None
    the mesh is a planning object: the sharding planner reads axis sizes
    only, and nothing can be placed on it."""

    def __init__(self, shape, axis_names, devices=None):
        shape = tuple(int(s) for s in shape)
        names = tuple(axis_names)
        if len(shape) != len(names) or len(set(names)) != len(names) or \
                any(s < 1 for s in shape):
            raise ValueError(f"a named mesh needs one size ≥ 1 for each distinct axis name, "
                             f"got shape {shape} and axes {names}")
        self.axis_names = names
        self.shape = dict(zip(names, shape))
        self.size = math.prod(shape)
        self.devices = None
        if devices is not None:
            self.devices = tuple(torch.device(d) for d in devices)
            if len(self.devices) != self.size:
                raise ValueError(f"a {shape} mesh takes {self.size} devices, got "
                                 f"{len(self.devices)}")

    def _key(self):
        return (tuple(self.shape.items()), self.devices)

    def __eq__(self, other) -> bool:
        return isinstance(other, NamedMesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        where = "planning" if self.devices is None else ", ".join(str(d) for d in self.devices)
        return f"NamedMesh({self.shape}, {where})"

    def axis_size(self, axis) -> int:
        """The size of an axis, of a tuple of axes (their product), 1 for None."""
        return math.prod(self.shape[a] for a in spec_axes(axis))

    def coords(self, rank: int) -> dict:
        """Rank → its index along each axis (row-major)."""
        out = {}
        for name in reversed(self.axis_names):
            rank, out[name] = divmod(rank, self.shape[name])
        return {name: out[name] for name in self.axis_names}

    def rank(self, **coords) -> int:
        """The rank at ``coords`` (axes left out: index 0)."""
        r = 0
        for name in self.axis_names:
            r = r * self.shape[name] + coords.get(name, 0)
        return r

    def require_devices(self) -> tuple:
        if self.devices is None:
            raise ValueError(f"{self!r} is a planning mesh: build one with devices "
                             "(launch.mesh.make_lm_mesh) to place tensors on it")
        return self.devices


def block_index(spec, mesh: NamedMesh, rank: int) -> tuple:
    """(index, count) of rank's block along each dimension under ``spec``."""
    c = mesh.coords(rank)
    out = []
    for entry in spec:
        idx, n = 0, 1
        for a in spec_axes(entry):
            idx, n = idx * mesh.shape[a] + c[a], n * mesh.shape[a]
        out.append((idx, n))
    return tuple(out)


def check_spec(shape, spec, mesh: NamedMesh) -> None:
    """Raise unless ``spec`` has one entry a dimension, names axes of the
    mesh, and splits each dimension into equal blocks."""
    if len(spec) != len(shape):
        raise ValueError(f"spec {spec} has {len(spec)} entries for a {len(shape)}-dim shape "
                         f"{tuple(shape)}")
    for dim, entry in zip(shape, spec):
        for a in spec_axes(entry):
            if a not in mesh.shape:
                raise ValueError(f"spec {spec} names axis {a!r}, not one of {mesh.axis_names}")
        if dim % mesh.axis_size(entry):
            raise ValueError(f"dimension {dim} of {tuple(shape)} does not divide over "
                             f"{entry} (size {mesh.axis_size(entry)})")


def block_slices(shape, spec, mesh: NamedMesh, rank: int) -> tuple:
    """The slices of a global array of ``shape`` that rank holds."""
    return tuple(slice(i * (d // n), (i + 1) * (d // n))
                 for d, (i, n) in zip(shape, block_index(spec, mesh, rank)))


def distinct_ranks(spec, mesh: NamedMesh) -> list[int]:
    """The first rank holding each distinct block, in rank order (ranks
    that differ only along axes the spec does not name hold copies)."""
    return list(_distinct_ranks(Spec(spec), mesh))


@functools.lru_cache(maxsize=4096)
def _distinct_ranks(spec, mesh: NamedMesh) -> tuple:
    seen, out = set(), []
    for r in range(mesh.size):
        idx = block_index(spec, mesh, r)
        if idx not in seen:
            seen.add(idx)
            out.append(r)
    return tuple(out)


def shard_named(x: torch.Tensor, spec, mesh: NamedMesh) -> list[torch.Tensor]:
    """x split under ``spec``: one block a rank, each its own contiguous
    copy on its rank's device (a replicated block is copied to every rank
    that holds it, as each device of the reference holds its own)."""
    devs = mesh.require_devices()
    check_spec(x.shape, spec, mesh)
    out = []
    for r, dev in enumerate(devs):
        part = x[block_slices(x.shape, spec, mesh, r)]
        out.append(torch.empty(part.shape, dtype=x.dtype, device=dev).copy_(part))
    return out


def gather_named(blocks, shape, spec, mesh: NamedMesh, device, dst: int = 0,
                 kind: str = "all-gather") -> torch.Tensor:
    """The global array of ``shape`` on ``device``, rank ``dst``'s, from its
    blocks (one a rank), each distinct block read once (a :func:`move`
    of ``kind`` from each other rank)."""
    first = blocks[0]
    out = torch.empty(tuple(shape), dtype=first.dtype, device=device)
    for r in distinct_ranks(spec, mesh):
        out[block_slices(shape, spec, mesh, r)] = move(blocks[r], device, r, dst, kind)
    return out


# --------------------------------------------------------------------------
# seams: where a tensor crosses between the ranks of a named mesh
# --------------------------------------------------------------------------
#: the kinds of crossing, the reference's collective names
SEAM_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")

_SEAMS: list = []  # the active count_seams records, innermost last
_RANKS: list = []  # the on_rank scopes, innermost last


def move(x: torch.Tensor, device, src: int, dst: int, kind: str) -> torch.Tensor:
    """``x``, rank ``src``'s, as rank ``dst``'s on ``device``: the one place
    a tensor crosses between ranks. Each active :func:`count_seams` record
    counts it under ``kind`` when rank 0 sends or receives it, whatever the
    devices (logical shards of one card or of the CPU count what separate
    cards would move)."""
    if _SEAMS and src != dst and 0 in (src, dst):
        nbytes = x.numel() * x.element_size()
        for rec in _SEAMS:
            rec[kind]["count"] += 1
            rec[kind]["bytes"] += nbytes
    return x.to(device)


@contextlib.contextmanager
def count_seams():
    """Yields ``{kind: {"count", "bytes"}, "total_bytes"}`` (the shape of
    ``roofline.collective_bytes``), filled by the :func:`move` calls inside
    that rank 0 sends or receives (one card's traffic, both directions);
    ``total_bytes`` is set on exit."""
    rec = {k: {"count": 0, "bytes": 0} for k in SEAM_KINDS}
    _SEAMS.append(rec)
    try:
        yield rec
    finally:
        _SEAMS.remove(rec)
        rec["total_bytes"] = sum(rec[k]["bytes"] for k in SEAM_KINDS)


@contextlib.contextmanager
def on_rank(rank: int):
    """Marks the work inside as rank ``rank``'s: one process drives every
    rank of a mesh, and a counter (``launch.dryrun``) reads
    :func:`current_rank` to tell one rank's work from another's."""
    _RANKS.append(rank)
    try:
        yield
    finally:
        _RANKS.pop()


def current_rank() -> int | None:
    """The rank of the innermost :func:`on_rank`, None outside any."""
    return _RANKS[-1] if _RANKS else None


# --------------------------------------------------------------------------
# collectives of an SPMD program: one tensor a rank, in rank order
# --------------------------------------------------------------------------
_LEAD: list = []  # the lead_rank_only scopes


@contextlib.contextmanager
def lead_rank_only():
    """Inside, a :class:`RankSet` on a mesh of ``meta`` devices drives rank 0
    alone (the dry run's count of one card's program on a production mesh)."""
    _LEAD.append(True)
    try:
        yield
    finally:
        _LEAD.pop()


class RankSet:
    """The ranks of a named mesh that one process drives, in rank order:
    every rank, or rank 0 alone on a ``meta`` mesh under
    :func:`lead_rank_only`. A per-rank value is a list aligned with
    :attr:`ranks`."""

    def __init__(self, mesh: NamedMesh):
        self.mesh = mesh
        self.devices = mesh.require_devices()
        self.lead = bool(_LEAD) and all(d.type == "meta" for d in self.devices)
        self.ranks = [0] if self.lead else list(range(mesh.size))
        self._groups: dict = {}

    def group(self, rank: int, axes) -> tuple:
        """The ranks that differ from ``rank`` only along ``axes``, in rank
        order (row-major over ``axes``: a block's index along them)."""
        key = (rank, axes)
        if key not in self._groups:
            c = self.mesh.coords(rank)
            self._groups[key] = tuple(
                r for r in range(self.mesh.size)
                if all(v == c[a] for a, v in self.mesh.coords(r).items() if a not in axes))
        return self._groups[key]

    def size(self, axes) -> int:
        return self.mesh.axis_size(axes)

    def value(self, xs: list, src: int):
        """Rank ``src``'s tensor of the per-rank list ``xs`` (rank 0's stands
        in for a rank that is not driven)."""
        return xs[0] if self.lead else xs[src]

    def each(self, fn, *lists) -> list:
        """``fn`` on each driven rank's arguments, under its :func:`on_rank`."""
        out = []
        for i, r in enumerate(self.ranks):
            with on_rank(r):
                out.append(fn(*(xs[i] for xs in lists)))
        return out

    def others(self, axes) -> tuple:
        """The ranks of rank 0's group that are not driven: rank 0's moves to
        them are made by rank 0 alone (a lead run)."""
        return self.group(0, axes)[1:] if self.lead else ()


def _in_order(parts: list, op: str) -> torch.Tensor:
    out = parts[0]
    for x in parts[1:]:
        out = out + x if op == "sum" else torch.maximum(out, x)
    return out


def _all_gather(rs: RankSet, xs: list, axes, dim: int, kind: str = "all-gather") -> list:
    out = []
    for r in rs.ranks:
        parts = [move(rs.value(xs, g), rs.devices[r], g, r, kind) for g in rs.group(r, axes)]
        with on_rank(r):
            out.append(torch.cat(parts, dim))
    for dst in rs.others(axes):
        move(xs[0], rs.devices[dst], 0, dst, kind)
    return out


def _reduce_scatter(rs: RankSet, xs: list, axes, dim: int, op: str = "sum",
                    kind: str = "reduce-scatter") -> list:
    n = rs.size(axes)
    blocks = [x.chunk(n, dim) for x in xs]  # each rank's n blocks, cut once
    out = []
    for r in rs.ranks:
        grp = rs.group(r, axes)
        k = grp.index(r)
        parts = [move(rs.value(blocks, g)[k], rs.devices[r], g, r, kind) for g in grp]
        with on_rank(r):
            out.append(_in_order(parts, op))
    for j, dst in enumerate(rs.others(axes), 1):
        move(blocks[0][j], rs.devices[dst], 0, dst, kind)
    return out


def _pieces(x: torch.Tensor, n: int) -> tuple:
    return torch.tensor_split(x.reshape(-1), n)


def _all_reduce(rs: RankSet, xs: list, axes, op: str = "sum") -> list:
    """Each rank's tensor the ``op`` (``sum`` or ``max``) over its group, in
    rank order: the n pieces of the flattened tensors reduce-scattered (rank
    k of the group sums piece k) and all-gathered; an empty piece does not
    move."""
    n = rs.size(axes)
    kind = "all-reduce"
    pieces = [_pieces(x, n) for x in xs]  # each rank's n pieces, cut once
    red = []
    for r in rs.ranks:
        grp = rs.group(r, axes)
        k = grp.index(r)
        own = rs.value(pieces, r)[k]
        parts = [own if g == r or not own.numel() else
                 move(rs.value(pieces, g)[k], rs.devices[r], g, r, kind) for g in grp]
        with on_rank(r):
            red.append(_in_order(parts, op))
    lead = pieces[0]
    for j, dst in enumerate(rs.others(axes), 1):
        if lead[j].numel():
            move(lead[j], rs.devices[dst], 0, dst, kind)
    out = []
    for i, r in enumerate(rs.ranks):
        grp = rs.group(r, axes)
        parts = []
        for j, g in enumerate(grp):
            piece = red[i] if g == r else (lead[j] if rs.lead else red[g])
            parts.append(piece if g == r or not piece.numel() else
                         move(piece, rs.devices[r], g, r, kind))
        with on_rank(r):
            out.append(torch.cat(parts).reshape(xs[i].shape))
    for dst in rs.others(axes):
        if lead[0].numel():
            move(red[0], rs.devices[dst], 0, dst, kind)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rs, axes, dim, *xs):
        ctx.rs, ctx.axes, ctx.dim = rs, axes, dim
        return tuple(_all_gather(rs, list(xs), axes, dim))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, None, *_reduce_scatter(ctx.rs, list(gs), ctx.axes, ctx.dim))


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rs, axes, dim, *xs):
        ctx.rs, ctx.axes, ctx.dim = rs, axes, dim
        return tuple(_reduce_scatter(rs, list(xs), axes, dim))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, None, *_all_gather(ctx.rs, list(gs), ctx.axes, ctx.dim))


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rs, axes, *xs):
        return tuple(_all_reduce(rs, list(xs), axes))

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, *gs)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rs, axes, *xs):
        ctx.rs, ctx.axes = rs, axes
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, *_all_reduce(ctx.rs, list(gs), ctx.axes))


def all_gather(rs: RankSet, xs: list, axes, dim: int) -> list:
    """Each rank's blocks of its ``axes`` group concatenated along ``dim``,
    in rank order; the backward reduce-scatters. A group of one is the
    identity."""
    axes = spec_axes(axes)
    return list(_AllGather.apply(rs, axes, dim, *xs)) if rs.size(axes) > 1 else list(xs)


def reduce_scatter(rs: RankSet, xs: list, axes, dim: int) -> list:
    """Each rank's block along ``dim`` of the sum, in rank order, of its
    ``axes`` group's tensors; the backward all-gathers."""
    axes = spec_axes(axes)
    return list(_ReduceScatter.apply(rs, axes, dim, *xs)) if rs.size(axes) > 1 else list(xs)


def all_reduce(rs: RankSet, xs: list, axes) -> list:
    """Each rank's tensor the sum, in rank order, of its ``axes`` group's
    (Megatron's *g*: the backward is the identity on each rank's
    gradient)."""
    axes = spec_axes(axes)
    return list(_AllReduce.apply(rs, axes, *xs)) if rs.size(axes) > 1 else list(xs)


def copy_to(rs: RankSet, xs: list, axes) -> list:
    """The identity whose backward all-reduces each rank's gradient over
    its ``axes`` group (Megatron's *f*)."""
    axes = spec_axes(axes)
    return list(_CopyTo.apply(rs, axes, *xs)) if rs.size(axes) > 1 else list(xs)


def all_reduce_max(rs: RankSet, xs: list, axes) -> list:
    """Each rank's tensor the elementwise max over its ``axes`` group (no
    gradient)."""
    axes = spec_axes(axes)
    if rs.size(axes) == 1:
        return list(xs)
    with torch.no_grad():
        return _all_reduce(rs, [x.detach() for x in xs], axes, "max")


def all_reduce_sum(rs: RankSet, xs: list, axes) -> list:
    """:func:`all_reduce` outside autograd (a gradient's sum after the
    backward)."""
    axes = spec_axes(axes)
    if rs.size(axes) == 1:
        return list(xs)
    with torch.no_grad():
        return _all_reduce(rs, list(xs), axes)
