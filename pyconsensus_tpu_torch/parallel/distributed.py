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
with the number of hosts. The hybrid (batch, event) mesh of
several slices (``make_hybrid_mesh``, ``num_slices``) is ``ROADMAP.md``
§A.10.
"""

from __future__ import annotations

from typing import Optional

import os

import numpy as np
import torch

#: the device scratch of one gathered slice of :func:`allreduce_sum`, all
#: hosts' copies together
GATHER_BYTES = 256 << 20

__all__ = ["initialize", "is_distributed", "rank", "world_size",
           "allreduce_sum"]


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
