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
"""
from __future__ import annotations

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
