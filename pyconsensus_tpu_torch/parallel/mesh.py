"""Event meshes and the placement of the storage matrix across them
(``pyconsensus_tpu/parallel/mesh.py`` and the placement half of
``pyconsensus_tpu/parallel/sharded.py``).

A mesh here is an ordered tuple of ``torch.device``\\ s along the
``"event"`` axis, driven by one controller process: the (R, E) storage
is split column-wise into one contiguous block per device, and the
first device holds every (R,)- and (E,)-sized vector
(:mod:`pyconsensus_tpu_torch.parallel.fused_sharded`). A list may name a
device more than once: ``make_mesh(devices=["cpu"] * 4)`` is four shards
on the CPU (the counterpart of the reference tests' 8-device CPU mesh)
and ``["cuda:0"] * 4`` four shards on one card.

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
           "EventShards", "place_event_shards", "scatter", "gather",
           "fold"]

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


def make_mesh(batch: int = 1, event: Optional[int] = None,
              devices: Optional[Sequence] = None) -> tuple:
    """An event mesh: the first ``event`` of ``devices`` (default: every
    visible CUDA device; with no card this raises, as ``resolve_device``
    does). A device may repeat, which makes a virtual mesh of several
    shards on one device."""
    if batch != 1:
        raise NotImplementedError(
            f"batch={batch}: batch x event meshes are not ported yet: "
            "ROADMAP.md §A.10 (multi-GPU)")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "devices=['cpu'] * n for a CPU mesh")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = tuple(_device(d) for d in devices)
    if event is None:
        event = len(devs)
    if not 1 <= event <= len(devs):
        raise ValueError(f"an event axis of {event} needs as many devices, "
                         f"have {len(devs)}")
    devs = devs[:event]
    if len({d.type for d in devs}) != 1:
        raise ValueError("a mesh is all CPU or all CUDA devices, got "
                         f"{[str(d) for d in devs]}")
    return devs


def as_mesh(mesh) -> tuple:
    """A mesh from :func:`make_mesh` or any sequence of devices."""
    if not isinstance(mesh, (tuple, list)):
        raise TypeError("mesh must be a sequence of devices (make_mesh), "
                        f"got {type(mesh).__name__}")
    return make_mesh(devices=mesh)


def effective_median_block(median_block: int, mesh) -> int:
    """The blocked weighted median's width: 0 (unblocked) when the mesh
    shards the event axis, the caller's width otherwise
    (``mesh.py:32``: the blocked median's slices do not partition over
    the event axis, and each shard bounds its own sort temporaries).
    Nothing calls it yet: only the plain pipeline's weighted median reads
    ``median_block``, and the fused paths have none."""
    if mesh is not None and len(mesh) > 1:
        return 0
    return median_block


class EventShards(NamedTuple):
    """A storage matrix placed on an event mesh: ``shards[i]`` (R, W_i)
    on ``mesh[i]`` holds the real columns ``[offsets[i], offsets[i] +
    widths[i])`` and ``W_i - widths[i]`` pad columns."""
    shards: tuple
    widths: tuple
    mesh: tuple
    n_events: int

    @property
    def offsets(self) -> tuple:
        return tuple(int(o) for o in np.cumsum((0,) + self.widths[:-1]))

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


def _padded(width: int) -> int:
    return max(_ALIGN_COLUMNS, -(-width // _ALIGN_COLUMNS) * _ALIGN_COLUMNS)


def place_event_shards(reports, mesh) -> EventShards:
    """Split the (R, E) storage into contiguous per-shard blocks, once,
    each on its mesh device: int8 sentinel storage keeps its dtype, float
    reports become float32 (NaN stays absent). A mesh of more than one
    shard pads each block to a multiple of 16 columns (module
    docstring); a one-shard mesh takes the single-device path, which
    needs no pad."""
    mesh = as_mesh(mesh)
    t = torch.as_tensor(reports)
    if t.dim() != 2:
        raise ValueError(f"reports must be 2-D, got shape {tuple(t.shape)}")
    dtype = torch.int8 if t.dtype == torch.int8 else torch.float32
    R, E = t.shape
    widths = _split(E, len(mesh))
    shards = []
    o = 0
    for dev, w in zip(mesh, widths):
        block = t[:, o:o + w].to(device=dev, dtype=dtype)
        o += w
        pad = (_padded(w) - w) if len(mesh) > 1 else 0
        if pad:
            block = torch.nn.functional.pad(block, (0, pad))
        shards.append(block.contiguous())
    return EventShards(tuple(shards), widths, mesh, E)


def scatter(v: torch.Tensor, placed: EventShards) -> list:
    """The (E,) vector ``v`` as per-shard (W_i,) slices on each shard's
    device, zero on the pad columns."""
    out = []
    for shard, o, w in zip(placed.shards, placed.offsets, placed.widths):
        piece = torch.nn.functional.pad(v[o:o + w], (0, shard.shape[1] - w))
        out.append(piece.to(shard.device, non_blocking=True))
    return out


def gather(pieces, placed: EventShards, dim: int = -1) -> torch.Tensor:
    """The per-shard outputs joined along their event axis ``dim`` on the
    first device, pad columns dropped."""
    dev = placed.mesh[0]
    return torch.cat([p.narrow(dim, 0, w).to(dev, non_blocking=True)
                      for p, w in zip(pieces, placed.widths)], dim=dim)


def fold(parts, device: torch.device) -> torch.Tensor:
    """Per-shard partial sums added on ``device`` as a left fold in shard
    order: the same bits on every run."""
    total = parts[0].to(device, non_blocking=True)
    for part in parts[1:]:
        total = total + part.to(device, non_blocking=True)
    return total
