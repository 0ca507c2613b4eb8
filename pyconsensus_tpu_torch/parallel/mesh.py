"""Event meshes, batch x event grids and the placement of the storage
matrix across them (``pyconsensus_tpu/parallel/mesh.py`` and the
placement half of ``pyconsensus_tpu/parallel/sharded.py``).

An event mesh here is an ordered tuple of ``torch.device``\\ s along the
``"event"`` axis, driven by one controller process: the (R, E) storage
is split column-wise into one contiguous block per device, and the
first device holds every (R,)- and (E,)-sized vector
(:mod:`pyconsensus_tpu_torch.parallel.fused_sharded`). A list may name a
device more than once: ``make_mesh(devices=["cpu"] * 4)`` is four shards
on the CPU (the counterpart of the reference tests' 8-device CPU mesh)
and ``["cuda:0"] * 4`` four shards on one card.

``make_mesh(batch=b)`` with ``b > 1`` is a :class:`DeviceGrid`: ``b``
rows of event meshes, the reference's ``("batch", "event")`` mesh. Its
rows carry independent work (the lanes of a serve dispatch, the
simulator's trials) and its columns split events. One matrix resolved on
a grid (``as_mesh``) runs on its first row: the reference places it
replicated over the batch axis, so every row would compute the same.

A :class:`ProcessMesh` (``parallel/distributed.py make_process_mesh``)
is an event mesh whose shards belong to several processes of a
``torch.distributed`` group, one program on every rank: rank 0's
devices first, then rank 1's. Each rank holds only its own shards, and
computes every (R,)- and (E,)-sized vector on its first device from the
same bits as every other rank: :func:`gather` joins the (E,) axis with
one all-gather, and :func:`fold` gathers every shard's partial and folds
them in global shard order, so a process mesh of n ranks x s shards
gives the bits of the one-controller mesh of n s shards on every rank.
A :class:`ProcessGrid` is the batch x event grid of such meshes
(``make_hybrid_mesh``); one matrix resolves on the row that holds this
rank.

Each shard's width is padded up to a multiple of 16 columns, so that
every storage pass loads 16 bytes at a time: 16 columns are one load of
int8 storage, which float reports become when ``storage_dtype="int8"``
encodes them per call, and four loads of float32. A pad column holds
the present value 0 in every row; with zero in every scattered (E,)
vector (the iterate, the means, the fill) it adds nothing to any sum,
and gathers drop it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

__all__ = ["make_mesh", "as_mesh", "effective_median_block",
           "DeviceGrid", "ProcessMesh", "ProcessGrid", "mesh_shape",
           "mesh_devices", "home_device", "local_devices", "is_process_mesh",
           "refuse_process_mesh",
           "EventShards", "place_event_shards", "place_batch_event_shards",
           "scatter", "gather", "fold", "shard_counts", "scatter_bounds"]

#: columns each shard's width is padded to a multiple of: one 16-byte
#: load of int8 storage, whatever dtype the reports are placed in
_ALIGN_COLUMNS = 16


def _device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "devices=['cpu'] * n for a CPU mesh")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


class DeviceGrid:
    """A batch x event grid of devices: ``rows[b]`` is the event mesh of
    batch row ``b``. ``shape`` is ``{"batch": b, "event": e}`` (the
    reference's ``Mesh.shape``) and ``devices`` the flat list, row by
    row."""

    __slots__ = ("rows",)

    def __init__(self, rows) -> None:
        self.rows = tuple(tuple(r) for r in rows)

    @property
    def shape(self) -> dict:
        return {"batch": len(self.rows), "event": len(self.rows[0])}

    @property
    def devices(self) -> list:
        return [d for row in self.rows for d in row]

    def __eq__(self, other) -> bool:
        return isinstance(other, DeviceGrid) and self.rows == other.rows

    def __hash__(self) -> int:
        return hash(self.rows)

    def __repr__(self) -> str:
        b, e = self.shape["batch"], self.shape["event"]
        return f"DeviceGrid({b}x{e}: {[str(d) for d in self.devices]})"


class ProcessMesh:
    """An event mesh over the ranks of a process group (module
    docstring). ``ranks`` are the group's members in mesh order,
    ``counts[i]`` and ``hosts[i]`` the shards and host name of member
    ``i``, ``index`` this process's place among them, ``local`` its own
    devices and ``group`` the ``torch.distributed`` group of the members
    (None: the default group). ``len()`` is the event axis's width, every
    member's shards together."""

    __slots__ = ("local", "ranks", "counts", "hosts", "index", "group")

    def __init__(self, local, ranks, counts, hosts, index: int,
                 group=None) -> None:
        self.local = tuple(local)
        self.ranks, self.counts = tuple(ranks), tuple(counts)
        self.hosts, self.index, self.group = tuple(hosts), int(index), group

    def __len__(self) -> int:
        return sum(self.counts)

    @property
    def first(self) -> int:
        """The global index of this process's first shard."""
        return sum(self.counts[:self.index])

    def __eq__(self, other) -> bool:
        return isinstance(other, ProcessMesh) and (
            self.local, self.ranks, self.counts, self.index) == (
            other.local, other.ranks, other.counts, other.index)

    def __hash__(self) -> int:
        return hash((self.local, self.ranks, self.counts, self.index))

    def __repr__(self) -> str:
        return (f"ProcessMesh(ranks {list(self.ranks)}, shards "
                f"{list(self.counts)}, this rank {self.ranks[self.index]} "
                f"on {[str(d) for d in self.local]})")


class ProcessGrid(DeviceGrid):
    """A batch x event grid whose rows span processes
    (``make_hybrid_mesh``): ``rows`` hold one descriptor a shard (its
    ``rank``, its ``index`` among that rank's devices, its ``device`` and
    its host's ``slice_index``), and ``mine`` is the event mesh of the row
    that holds this rank (of a rank that fills several rows alone, its
    first, as a mesh of its own devices), on which one matrix resolves
    (every row computes the same bits)."""

    __slots__ = ("mine",)

    def __init__(self, rows, mine) -> None:
        super().__init__(rows)
        self.mine = mine


def is_process_mesh(mesh) -> bool:
    """Whether ``mesh`` (a mesh, a grid or placed shards) spans
    processes."""
    if isinstance(mesh, EventShards):
        mesh = mesh.mesh
    return isinstance(mesh, (ProcessMesh, ProcessGrid))


def refuse_process_mesh(mesh, what: str, hint: str = "") -> None:
    """Raise the ``ValueError`` of a consumer that does not run on a mesh
    spanning processes yet (``ROADMAP.md`` §A.10)."""
    if is_process_mesh(mesh):
        raise ValueError(f"{what} on a mesh that spans processes is "
                         f"ROADMAP.md §A.10, not ported yet{hint}")


def home_device(mesh) -> torch.device:
    """This process's first device of an event mesh, which holds every
    (R,)- and (E,)-sized vector of a resolution."""
    mesh = as_mesh(mesh)
    return mesh.local[0] if isinstance(mesh, ProcessMesh) else mesh[0]


def local_devices(mesh) -> tuple:
    """The devices of an event mesh that this process drives."""
    mesh = as_mesh(mesh)
    return mesh.local if isinstance(mesh, ProcessMesh) else mesh


def make_mesh(batch: int = 1, event: Optional[int] = None,
              devices: Optional[Sequence] = None):
    """A ``batch`` x ``event`` mesh over ``devices`` (default: every
    visible CUDA device; with no card this raises, as ``resolve_device``
    does), laid out row by row as the reference's ``make_mesh``. ``event``
    defaults to every device left over: ``batch`` must then divide the
    device count. A device may repeat, which makes a virtual mesh of
    several shards on one device. ``batch=1`` returns the event mesh, a
    tuple of devices; ``batch > 1`` a :class:`DeviceGrid`."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "devices=['cpu'] * n for a CPU mesh")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = tuple(_device(d) for d in devices)
    n = len(devs)
    batch = int(batch)
    if batch < 1:
        raise ValueError(f"batch={batch} must be >= 1")
    if event is None:
        if n % batch:
            raise ValueError(f"batch={batch} does not divide {n} devices")
        event = n // batch
    if batch == 1 and not 1 <= event <= n:
        raise ValueError(f"an event axis of {event} needs as many devices, "
                         f"have {n}")
    if event < 1 or batch * event > n:
        raise ValueError(f"mesh {batch}x{event} needs {batch * event} "
                         f"devices, have {n}")
    devs = devs[:batch * event]
    if len({d.type for d in devs}) != 1:
        raise ValueError("a mesh is all CPU or all CUDA devices, got "
                         f"{[str(d) for d in devs]}")
    if batch == 1:
        return devs
    return DeviceGrid(devs[i * event:(i + 1) * event] for i in range(batch))


def mesh_shape(mesh) -> tuple:
    """``(batch, event)`` of a grid or an event mesh (``(1, 1)`` for
    None)."""
    if mesh is None:
        return 1, 1
    if isinstance(mesh, DeviceGrid):
        return mesh.shape["batch"], mesh.shape["event"]
    return 1, len(mesh)


def mesh_devices(mesh) -> tuple:
    """Every device of a grid (row by row) or of an event mesh (of a
    process mesh, this process's)."""
    if isinstance(mesh, DeviceGrid):
        return tuple(mesh.devices)
    return local_devices(mesh)


def as_mesh(mesh):
    """The event mesh of one matrix: a mesh from :func:`make_mesh`, any
    sequence of devices, a grid's first row (the reference replicates
    one matrix over the batch axis), a :class:`ProcessMesh`, or the row
    of a :class:`ProcessGrid` that holds this rank."""
    if isinstance(mesh, ProcessGrid):
        return mesh.mine
    if isinstance(mesh, ProcessMesh):
        return mesh
    if isinstance(mesh, DeviceGrid):
        return mesh.rows[0]
    if not isinstance(mesh, (tuple, list)):
        raise TypeError("mesh must be a sequence of devices (make_mesh), "
                        f"got {type(mesh).__name__}")
    return make_mesh(devices=mesh)


def effective_median_block(median_block: int, mesh) -> int:
    """The blocked weighted median's width: 0 (unblocked) when the mesh
    shards the event axis, the caller's width otherwise
    (``mesh.py:32``: the blocked median's slices do not partition over
    the event axis, and each shard bounds its own sort temporaries).
    The front door sets it on the parameters of a mesh, the plain mesh
    core's outcome resolution reads it, and the out-of-core driver's
    resolve pass calls it; the fused paths have no blocked median. A grid
    reads its event axis."""
    if mesh_shape(mesh)[1] > 1:
        return 0
    return median_block


class EventShards(NamedTuple):
    """A storage matrix placed on an event mesh: the mesh's shard ``j``
    (R, W_j) holds the real columns ``[offsets[j], offsets[j] +
    widths[j])`` and ``W_j - widths[j]`` pad columns. ``widths``,
    ``offsets``, ``shape`` and ``n_events`` are the whole mesh's;
    ``shards`` are the ones this process holds, shards ``first`` to
    ``first + len(shards) - 1`` of the mesh (all of them, from 0, on a
    mesh of one controller), each on its device of ``local_devices``."""
    shards: tuple
    widths: tuple
    mesh: tuple
    n_events: int
    first: int = 0

    @property
    def offsets(self) -> tuple:
        return tuple(int(o) for o in np.cumsum((0,) + self.widths[:-1]))

    @property
    def local_offsets(self) -> tuple:
        """The offsets of this process's shards."""
        return self.offsets[self.first:self.first + len(self.shards)]

    @property
    def local_widths(self) -> tuple:
        """The real widths of this process's shards."""
        return self.widths[self.first:self.first + len(self.shards)]

    @property
    def home(self) -> torch.device:
        """The mesh's first device in this process (``home_device``)."""
        mesh = self.mesh
        return mesh.local[0] if isinstance(mesh, ProcessMesh) else mesh[0]

    @property
    def shape(self) -> tuple:
        return (self.shards[0].shape[0], self.n_events)

    @property
    def ndim(self) -> int:
        return 2

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype


def _split(E: int, n: int) -> tuple:
    """Contiguous shard widths, the first ``E % n`` one wider."""
    return tuple(E // n + (1 if i < E % n else 0) for i in range(n))


def padded_width(width: int) -> int:
    """A shard width padded up to a multiple of 16 columns (module
    docstring)."""
    return max(_ALIGN_COLUMNS, -(-width // _ALIGN_COLUMNS) * _ALIGN_COLUMNS)


def _place_columns(t, devs, dtype, widths=None, first: int = 0) -> tuple:
    """Blocks of ``t``'s last axis, one on each of ``devs``: the
    contiguous split of the axis over ``devs`` or, given ``widths`` (every
    shard's of a larger mesh), its shards ``first`` onward. Each block is
    padded with zeros to a multiple of 16 columns when the mesh has more
    than one shard. A numpy ``t`` is copied one block at a time. Returns
    ``(shards, widths)``."""
    host = isinstance(t, np.ndarray)
    widths = _split(t.shape[-1], len(devs)) if widths is None else widths
    o = sum(widths[:first])
    shards = []
    for dev, w in zip(devs, widths[first:]):
        block = t[..., o:o + w]
        if host:
            block = torch.from_numpy(np.array(block, order="C"))
        block = block.to(device=dev, dtype=dtype)
        o += w
        pad = (padded_width(w) - w) if len(widths) > 1 else 0
        if pad:
            block = torch.nn.functional.pad(block, (0, pad))
        shards.append(block.contiguous())
    return tuple(shards), widths


def place_event_shards(reports, mesh, dtype=None) -> EventShards:
    """Split the (R, E) storage into contiguous per-shard blocks, once,
    each on its mesh device: int8 sentinel storage keeps its dtype, float
    reports become float32 (NaN stays absent), unless ``dtype`` says
    otherwise. A numpy matrix (a memory map too) is copied one block at a
    time, so the host holds at most one shard beside it. A mesh of more
    than one shard pads each block to a multiple of 16 columns (module
    docstring); a one-shard mesh takes the single-device path, which
    needs no pad. On a :class:`ProcessMesh` every rank passes the same
    matrix and places only its own shards' columns."""
    mesh = as_mesh(mesh)
    host = isinstance(reports, np.ndarray)
    t = reports if host else torch.as_tensor(reports)
    if t.ndim != 2:
        raise ValueError(f"reports must be 2-D, got shape {tuple(t.shape)}")
    if dtype is None:
        int8 = t.dtype == (np.int8 if host else torch.int8)
        dtype = torch.int8 if int8 else torch.float32
    if isinstance(mesh, ProcessMesh):
        shards, widths = _place_columns(t, mesh.local, dtype,
                                        _split(t.shape[1], len(mesh)),
                                        mesh.first)
        return EventShards(shards, widths, mesh, t.shape[1], mesh.first)
    shards, widths = _place_columns(t, mesh, dtype)
    return EventShards(shards, widths, mesh, t.shape[1])


def place_batch_event_shards(stack, mesh,
                             capacity: Optional[int] = None) -> tuple:
    """A (B, ..., E) stack on a batch x event mesh (the reference's
    ``batch_event_sharding``, ``P("batch", None, "event")``): lane ``b``
    on grid row ``b // (capacity / batch)``, its last axis split over the
    row's devices as :func:`place_event_shards` splits it (16-column pad
    of zeros), in the stack's dtype. ``capacity`` (default ``B``) must
    divide over the batch axis; a stack of fewer lanes leaves the last
    rows without work. Returns one ``(lo, hi, EventShards)`` per row that
    holds lanes ``[lo, hi)``, its shards (hi - lo, ..., W_i)."""
    rows = mesh.rows if isinstance(mesh, DeviceGrid) else (as_mesh(mesh),)
    B = int(stack.shape[0])
    capacity = B if capacity is None else int(capacity)
    if capacity % len(rows) or B > capacity:
        raise ValueError(f"a capacity of {capacity} lanes ({B} placed) "
                         f"does not divide over a batch axis of {len(rows)}")
    per = capacity // len(rows)
    out = []
    for r, devs in enumerate(rows):
        lo, hi = r * per, min((r + 1) * per, B)
        if lo >= hi:
            break
        shards, widths = _place_columns(stack[lo:hi], devs, stack.dtype)
        out.append((lo, hi, EventShards(shards, widths, devs,
                                        int(stack.shape[-1]))))
    return tuple(out)


def scatter(v: torch.Tensor, placed: EventShards, dim: int = 0) -> list:
    """The event axis ``dim`` of ``v`` ((E,), (E, k) or a lane stack
    (n, E) with ``dim=1``) as this process's per-shard slices of width
    W_i on each shard's device, zero on the pad columns. Each slice is a
    fresh allocation, so the kernels' aligned loads hold."""
    out = []
    for shard, o, w in zip(placed.shards, placed.local_offsets,
                           placed.local_widths):
        shape = list(v.shape)
        shape[dim] = shard.shape[-1]
        piece = v.new_zeros(shape)
        piece.narrow(dim, 0, w).copy_(v.narrow(dim, o, w))
        out.append(piece.to(shard.device, non_blocking=True))
    return out


def shard_counts(mask, placed: EventShards) -> tuple:
    """How many events of the (E,) host mask fall on each of this
    process's shards."""
    m = np.asarray(mask, dtype=bool)
    return tuple(int(m[o:o + w].sum())
                 for o, w in zip(placed.local_offsets, placed.local_widths))


def scatter_bounds(scaled, mins, maxs, placed: EventShards) -> list:
    """The event bounds as this process's per-shard ``(scaled, mins,
    maxs)`` slices on each shard's device, the bounds in float32 as one
    device takes them. A pad column is a binary event on [0, 1], which
    rescale leaves as it is."""
    fdt = torch.float32
    out = []
    for shard, o, w in zip(placed.shards, placed.local_offsets,
                           placed.local_widths):
        W, dev = shard.shape[-1], shard.device
        sc = torch.zeros(W, dtype=torch.bool)
        lo = torch.zeros(W, dtype=fdt)
        hi = torch.ones(W, dtype=fdt)
        sc[:w] = torch.as_tensor(np.asarray(scaled[o:o + w], dtype=bool))
        lo[:w] = torch.as_tensor(np.asarray(mins[o:o + w]), dtype=fdt)
        hi[:w] = torch.as_tensor(np.asarray(maxs[o:o + w]), dtype=fdt)
        out.append((sc.to(dev), lo.to(dev), hi.to(dev)))
    return out


def gather(pieces, placed: EventShards, dim: int = -1) -> torch.Tensor:
    """The per-shard outputs joined along their event axis ``dim`` on the
    first device, pad columns dropped; on a :class:`ProcessMesh` every
    rank's pieces, joined on every rank (one all-gather)."""
    dev = placed.home
    own = [p.narrow(dim, 0, w).to(dev, non_blocking=True)
           for p, w in zip(pieces, placed.local_widths)]
    if isinstance(placed.mesh, ProcessMesh):
        from .distributed import gather_columns

        return gather_columns(own, placed.mesh, placed.widths, dim)
    return torch.cat(own, dim=dim)


def fold(parts, device: torch.device, mesh=None) -> torch.Tensor:
    """Per-shard partial sums added on ``device`` as a left fold in shard
    order: the same bits on every run. On a :class:`ProcessMesh`
    ``parts`` are this rank's, and every shard's partial of every rank is
    folded in global shard order on every rank: the bits of the
    one-controller mesh of as many shards."""
    if isinstance(mesh, ProcessMesh):
        from .distributed import fold_shards

        return fold_shards(parts, device, mesh)
    total = parts[0].to(device, non_blocking=True)
    for part in parts[1:]:
        total = total + part.to(device, non_blocking=True)
    return total
