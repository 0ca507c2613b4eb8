"""Several processes, one resolution: joining a ``torch.distributed``
process group (``pyconsensus_tpu/parallel/distributed.py:41``) and the
cross-host sum of the out-of-core driver.

Every host runs the same program. :func:`initialize` is the one call a
launcher makes on each host, before the first resolution: it joins the
process group at a TCP rendezvous (``tcp://<coordinator>``; nothing on
the card's machine tells a program of a cluster, so the address, the
world size and the rank are explicit). The backend is NCCL for the card
and gloo for an explicit ``device="cpu"`` (the CPU tests). Under NCCL
each process takes its own local card: ``LOCAL_RANK`` where a launcher
sets it, else ``process_id`` modulo the host's cards.

:func:`allreduce_sum` is ``streaming_consensus``'s default reduction: it
gathers every host's array and sums them in host order,
``x_0 + x_1 + ...``, so each host gets the same bits and the sum's order
is the one the threaded rendezvous of the tests uses (a collective's own
reduction order is the library's). It gathers in slices of at most
``GATHER_BYTES`` for all hosts together, so its scratch does not grow
with the number of hosts.

The process mesh (``pyconsensus_tpu/parallel/distributed.py:115-168``):
:func:`make_process_mesh` builds the event axis over every rank's local
devices, rank 0's first (:class:`~.mesh.ProcessMesh`); every rank runs
the same program on the same host matrix, places only its own shards'
columns, and gets the whole result. Its collectives are
:func:`gather_columns`, one all-gather of every rank's real columns, and
:func:`fold_shards`, which gathers every shard's partial (not every
rank's sum) and folds them in global shard order, in slices of at most
``GATHER_BYTES``. A slice (:func:`num_slices`) is a host, the cards that
share one machine's NVLink as the reference's ICI slice shares its
interconnect: :func:`make_hybrid_mesh` lays the batch axis across hosts
and keeps each event row inside one host, by the reference's rules.
"""

from __future__ import annotations

import os
import socket
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from .mesh import DeviceGrid, ProcessGrid, ProcessMesh, _device, make_mesh

#: the device scratch of one gathered slice of :func:`allreduce_sum` and
#: :func:`fold_shards`, all hosts' copies together
GATHER_BYTES = 256 << 20

__all__ = ["initialize", "is_distributed", "rank", "world_size",
           "allreduce_sum", "make_process_mesh", "num_slices",
           "make_hybrid_mesh", "gather_columns", "fold_shards"]


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, device=None) -> None:
    """Join this process to the process group of ``num_processes`` hosts
    (idempotent: a second call, or a group some launcher already
    initialised, is a no-op). ``coordinator_address`` is the ``host:port``
    every host passes alike; ``device`` None means the card (NCCL, which
    raises without one), ``"cpu"`` gloo. A failure raises: a misconfigured
    launch never goes on as isolated single-host runs. Under NCCL a
    device with no index takes the local card ``LOCAL_RANK`` or, without
    it, ``process_id`` modulo the host's cards: two processes never share
    one, which NCCL refuses."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    if not coordinator_address:
        raise ValueError("initialize needs the coordinator's host:port")
    if not 0 <= int(process_id) < int(num_processes):
        raise ValueError(f"process_id {process_id} not in "
                         f"[0, {num_processes})")
    from .sharded import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev if dev.index is not None
                              else _local_card(process_id))
    dist.init_process_group(
        backend="nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id))


def _local_card(process_id: int) -> int:
    """This process's card on its host: ``LOCAL_RANK`` where a launcher
    sets it, else ``process_id`` modulo the host's cards."""
    return int(os.environ.get("LOCAL_RANK", process_id)) \
        % torch.cuda.device_count()


def is_distributed() -> bool:
    """Whether this process belongs to a process group of several."""
    return world_size() > 1


def rank() -> int:
    """This process's rank, 0 outside a process group."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    """The process group's size, 1 outside one."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def _collective_device() -> torch.device:
    """Where the group's collectives take tensors: the current card under
    NCCL, the host under gloo."""
    import torch.distributed as dist

    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def allreduce_sum(x):
    """The sum of ``x`` over every process of the group, in rank order.
    ``x`` is a numpy array (the result is a float64 numpy array) or a
    tensor (the result is a tensor of its dtype on its device); it crosses
    to the collective's device and back only where that differs. Slices
    of ``x`` are gathered one after another, all hosts' copies of one
    slice taking at most ``GATHER_BYTES``."""
    import torch.distributed as dist

    as_numpy = not isinstance(x, torch.Tensor)
    t = torch.from_numpy(np.asarray(x, dtype=np.float64)) if as_numpy else x
    home, shape = t.device, t.shape
    flat = t.to(_collective_device()).reshape(-1)
    world = dist.get_world_size()
    step = max(1, GATHER_BYTES // (world * flat.element_size()))
    total = torch.empty_like(flat)
    for a in range(0, flat.numel(), step):
        piece = flat[a:a + step].contiguous()
        parts = [torch.empty_like(piece) for _ in range(world)]
        dist.all_gather(parts, piece)
        acc: Optional[torch.Tensor] = None
        for part in parts:                      # host order
            acc = part if acc is None else acc + part
        total[a:a + step] = acc
    total = total.reshape(shape).to(home)
    return total.numpy() if as_numpy else total


# -- the process mesh -----------------------------------------------------


class _Shard(NamedTuple):
    """One shard of a mesh that spans processes: the rank that holds it,
    its place among that rank's devices and its device's name there, and
    its host's index (the reference's ``slice_index``)."""
    rank: int
    index: int
    device: str
    slice_index: int


def _group():
    """``torch.distributed``, raising outside an initialised process
    group."""
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("a mesh that spans processes needs a process "
                           "group: call parallel.distributed.initialize "
                           "on every rank first")
    return dist


def _local_devices(devices) -> tuple:
    """This rank's devices of a process mesh: ``devices``, or the current
    card (raising without one: a rank never falls back to the CPU)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available for this rank; "
                               "pass devices=['cpu'] * n for CPU shards")
        return (torch.device("cuda", torch.cuda.current_device()),)
    local = tuple(_device(d) for d in devices)
    if not local or len({d.type for d in local}) != 1:
        raise ValueError("a rank's devices are one or more CPU or CUDA "
                         f"devices, got {[str(d) for d in local]}")
    return local


def _members(local: tuple) -> list:
    """``(device names, host)`` of every rank, in rank order: one
    ``all_gather_object``, which every rank calls. Raises when the
    ranks' device types differ."""
    dist = _group()
    infos = [None] * dist.get_world_size()
    dist.all_gather_object(infos, ([str(d) for d in local],
                                   socket.gethostname(), local[0].type))
    kinds = [kind for _, _, kind in infos]
    if len(set(kinds)) != 1:
        raise ValueError(f"the ranks' devices are of different types: "
                         f"{kinds}")
    return [(names, host) for names, host, _ in infos]


def _process_mesh(local: tuple, infos: list, ranks: list,
                  group=None) -> ProcessMesh:
    """This rank's :class:`~.mesh.ProcessMesh` over ``ranks``."""
    return ProcessMesh(local, ranks, [len(infos[r][0]) for r in ranks],
                       [infos[r][1] for r in ranks],
                       ranks.index(_group().get_rank()), group)


def make_process_mesh(devices: Optional[Sequence] = None) -> ProcessMesh:
    """The event mesh over every rank of the process group, each rank's
    ``devices`` (default: its current card) in rank order. Every rank
    calls it; it learns every rank's devices and host with one
    ``all_gather_object``. Raises outside an initialised process group,
    and when the ranks' device types differ."""
    local = _local_devices(devices)
    infos = _members(local)
    return _process_mesh(local, infos, list(range(len(infos))))


def _slice_index(device) -> int:
    """The slice of a device descriptor: its ``slice_index`` where it
    carries one (the reference's ``_slice_index``), else 0."""
    return getattr(device, "slice_index", 0)


def num_slices(devices: Optional[Sequence] = None) -> int:
    """The slices of ``devices`` (objects with a ``slice_index`` count by
    it, any other device as slice 0) or, by default, the distinct hosts
    of the process group (one ``all_gather_object``, which every rank
    calls); 1 outside a group."""
    if devices is not None:
        return len({_slice_index(d) for d in devices})
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized():
        return 1
    hosts = [None] * dist.get_world_size()
    dist.all_gather_object(hosts, socket.gethostname())
    return len(set(hosts))


def _hybrid_rows(devices: list, batch: Optional[int]) -> list:
    """The reference's layout (``pyconsensus_tpu/parallel/
    distributed.py:139-168``): the slices in order, each cut into
    ``batch / slices`` rows, so that the batch axis crosses slices and
    each event row stays inside one."""
    slices = sorted({_slice_index(d) for d in devices})
    by_slice = [[d for d in devices if _slice_index(d) == s]
                for s in slices]
    per = len(by_slice[0])
    if any(len(g) != per for g in by_slice):
        raise ValueError("uneven chips per slice: "
                         f"{[len(g) for g in by_slice]}")
    n_slices = len(slices)
    batch = batch if batch is not None else n_slices
    if batch % n_slices != 0:
        raise ValueError(f"batch={batch} must be a multiple of the slice "
                         f"count {n_slices} so the event axis stays inside "
                         "a slice")
    sub = batch // n_slices
    if per % sub != 0:
        raise ValueError(f"chips-per-slice {per} not divisible by "
                         f"within-slice batch factor {sub}")
    step = per // sub
    return [g[i * step:(i + 1) * step] for g in by_slice for i in range(sub)]


def make_hybrid_mesh(batch: Optional[int] = None,
                     devices: Optional[Sequence] = None):
    """The (batch, event) mesh with the batch axis across hosts and each
    event row inside one host (the reference's ``make_hybrid_mesh``).

    - ``devices`` that carry a ``slice_index`` (a topology's descriptors,
      as the reference's tests fake one): their grid of several slices
      (a :class:`~.mesh.DeviceGrid` of them), by the reference's rules.
    - Outside a process group: ``make_mesh(batch or 1, devices=devices)``.
    - In a group (every rank calls it; ``devices`` are this rank's,
      default its current card): one slice and ``batch`` None or 1 gives
      :func:`make_process_mesh`'s mesh; otherwise a
      :class:`~.mesh.ProcessGrid` whose rows divide the slices, each
      row's ranks joined in a group of their own. A rank's devices lie in
      one row, on which one matrix resolves.

    Raises the reference's ``ValueError`` when ``batch`` is not a multiple
    of the slice count or the slices hold uneven device counts."""
    if devices is not None and any(hasattr(d, "slice_index")
                                   for d in devices):
        devices = list(devices)
        if num_slices(devices) <= 1:
            return make_mesh(batch=batch or 1, devices=devices)
        return DeviceGrid(_hybrid_rows(devices, batch))
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized():
        return make_mesh(batch=batch or 1, devices=devices)
    local = _local_devices(devices)
    infos = _members(local)
    hosts = list(dict.fromkeys(host for _, host in infos))
    if len(hosts) == 1 and (batch or 1) == 1:
        return _process_mesh(local, infos, list(range(len(infos))))
    rows = _hybrid_rows([_Shard(r, i, name, hosts.index(host))
                         for r, (names, host) in enumerate(infos)
                         for i, name in enumerate(names)], batch)
    me, mine = dist.get_rank(), None
    for row in rows:
        ranks = list(dict.fromkeys(s.rank for s in row))
        if len(ranks) == 1:
            # a row inside one rank: that rank drives it alone
            if ranks[0] == me and mine is None:
                mine = tuple(local[s.index] for s in row)
            continue
        if sum(len(infos[r][0]) for r in ranks) != len(row):
            raise ValueError("a rank's devices lie in one event row, or in "
                             "rows of their own; got rows "
                             f"{[[s.rank for s in r] for r in rows]}")
        # every rank creates every row's group, in the same order
        group = None if len(ranks) == len(infos) else dist.new_group(ranks)
        if me in ranks:
            mine = _process_mesh(local, infos, ranks, group)
    return ProcessGrid(rows, mine)


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """A tensor's elements as a flat uint8 tensor (a collective's common
    currency: NCCL and gloo gather bytes of every dtype alike)."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def _all_gather(buf: torch.Tensor, group) -> torch.Tensor:
    """Every member's equal-sized flat ``buf`` as the rows of one
    (members, n) tensor on ``buf``'s device, by one all-gather into a
    single buffer; the collective itself runs on the group's collective
    device (the current card under NCCL, after every op queued before it
    on the current stream)."""
    dist = _group()
    src = buf.to(_collective_device())
    out = src.new_empty(dist.get_world_size(group) * src.numel())
    dist.all_gather_into_tensor(out, src, group=group)
    return out.view(-1, src.numel()).to(buf.device)


def gather_columns(own: list, mesh: ProcessMesh, widths: Sequence,
                   dim: int) -> torch.Tensor:
    """``mesh.gather`` across processes: this rank's pieces ``own`` (its
    shards' real columns along ``dim``, on its first device) joined with
    every other rank's along ``dim`` in shard order, on every rank. One
    all-gather of each rank's columns, padded to the widest rank's."""
    local = (own[0] if len(own) == 1 else torch.cat(own, dim=dim))
    local = local.movedim(dim, 0)
    rest, dtype = tuple(local.shape[1:]), local.dtype
    per_col = int(np.prod(rest, dtype=np.int64)) * local.element_size()
    ends = np.cumsum((0,) + tuple(mesh.counts))
    cols = [int(sum(widths[a:b])) for a, b in zip(ends[:-1], ends[1:])]
    buf = _as_bytes(local)
    size = max(cols) * per_col
    if buf.numel() < size:
        buf = torch.nn.functional.pad(buf, (0, size - buf.numel()))
    got = _all_gather(buf, mesh.group)
    if min(cols) == max(cols):          # no pad: the rows end to end
        full = got.reshape(-1).view(dtype)
    else:
        full = torch.cat([got[i, :c * per_col].view(dtype)
                          for i, c in enumerate(cols)])
    return full.reshape(-1, *rest).movedim(0, dim).contiguous()


def fold_shards(parts: list, device: torch.device,
                mesh: ProcessMesh) -> torch.Tensor:
    """``mesh.fold`` across processes: this rank's per-shard partials
    ``parts`` (one shape and dtype) and every other rank's, gathered in
    slices of at most ``GATHER_BYTES`` (all ranks' copies together) and
    added on ``device`` as one left fold in global shard order, so every
    rank gets the one-controller mesh's bits."""
    shape, dtype = parts[0].shape, parts[0].dtype
    n, slots = parts[0].numel(), max(mesh.counts)
    if slots == 1:
        stack = parts[0].to(device).reshape(1, n)
    else:
        stack = torch.zeros((slots, n), dtype=dtype, device=device)
        for q, part in enumerate(parts):
            stack[q].copy_(part.reshape(-1), non_blocking=True)
    step = max(1, GATHER_BYTES // (len(mesh.counts) * slots
                                   * stack.element_size()))
    pieces = []
    for a in range(0, n, step):
        got = _all_gather(_as_bytes(stack[:, a:a + step]), mesh.group)
        got = got.view(dtype).reshape(len(mesh.counts), slots, -1)
        acc: Optional[torch.Tensor] = None
        for m, count in enumerate(mesh.counts):
            for q in range(count):               # global shard order
                acc = got[m, q] if acc is None else acc + got[m, q]
        pieces.append(acc)
    total = pieces[0] if len(pieces) == 1 else torch.cat(pieces)
    return total.reshape(shape)
