"""Memory-bandwidth roofline model of consensus resolutions
(``pyconsensus_tpu/tune/roofline.py``).

It says why a path is slow: a host-bound path (intake, synchronous
dispatch, fetches) is fixed by host work, while a bandwidth-bound one
already runs as fast as the memory allows and only storage compression
or more cards move it.

- :func:`stream_bandwidth_bytes_per_s` measures the device's achievable
  stream rate with one elementwise pass over a matrix-scale buffer (on
  the card timed with CUDA events), the same kind of traffic the storage
  sweeps issue, so the bound is an achievable roof, not a data-sheet
  number (3.35 TB/s on an H100 SXM);
- :func:`resolution_traffic_bytes` models one fused resolution's memory
  traffic: the fill pass reads the accumulation-dtype matrix once and
  writes storage once, then every power sweep, the scores and
  direction-fix pass and the fused back half each read storage once per
  outer iteration;
- :func:`bound_resolutions_per_sec` divides the two, and
  :func:`classify_regime` places an achieved rate against it.

The arithmetic is the reference's. The model's one free parameter is the
power sweep count (the early exit makes it data-dependent); callers pass
their measured or assumed value and say which it was.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..parallel.sharded import resolve_device

__all__ = ["stream_bandwidth_bytes_per_s", "resolution_traffic_bytes",
           "bound_resolutions_per_sec", "classify_regime"]


def stream_bandwidth_bytes_per_s(mbytes: int = 64, repeats: int = 5,
                                 device=None) -> float:
    """Measured stream bandwidth (bytes/s) of ``device`` (None: the card):
    ``y = x + 0.5`` over an ``mbytes`` float32 buffer, one read and one
    write of it per pass, the median of ``repeats`` passes after a warm-up
    (CUDA events on the card, the host clock on the CPU)."""
    dev = resolve_device(device)
    n = max(1, int(mbytes) * (1 << 20) // 4)
    x = torch.ones((n,), dtype=torch.float32, device=dev)
    y = torch.empty_like(x)
    torch.add(x, 0.5, out=y)                    # warm
    samples = []
    for _ in range(max(1, repeats)):
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                torch.add(x, 0.5, out=y)
                b.record()
                b.synchronize()
                samples.append(a.elapsed_time(b) * 1e-3)
        else:
            t0 = time.perf_counter()
            torch.add(x, 0.5, out=y)
            samples.append(time.perf_counter() - t0)
    return 2.0 * n * 4 / float(np.median(samples))


def resolution_traffic_bytes(R: int, E: int, storage_itemsize: int,
                             sweeps: int, iterations: int = 1,
                             acc_itemsize: int = 4) -> int:
    """Modeled memory bytes of one fused resolution at (R, E): the fill
    pass (one acc-dtype read + one storage write) plus, per outer
    iteration, ``sweeps`` power-sweep storage reads and two more storage
    passes (scores + direction fix; the fused back half)."""
    cells = int(R) * int(E)
    fill = cells * (int(acc_itemsize) + int(storage_itemsize))
    per_iter = (int(sweeps) + 2) * cells * int(storage_itemsize)
    return fill + max(1, int(iterations)) * per_iter


def bound_resolutions_per_sec(bandwidth_bytes_per_s: float,
                              traffic_bytes: int) -> float:
    """The memory-bandwidth-bound resolution rate for a traffic model —
    the roof the achieved rate is compared against."""
    return float(bandwidth_bytes_per_s) / max(1, int(traffic_bytes))


def classify_regime(achieved: float, bound: float,
                    threshold: float = 0.5) -> str:
    """``"bandwidth-bound"`` when the achieved rate is within
    ``threshold`` of the roof, else ``"host-bound"``."""
    if bound <= 0:
        return "unknown"
    return ("bandwidth-bound" if achieved / bound >= threshold
            else "host-bound")
