"""The continuous micro-batching dispatch loop
(``pyconsensus_tpu/serve/batcher.py``).

The batcher thread drains the request queue: the oldest request opens a
batch, compatible requests (identical ``batch_key``: bucket shape,
static params, kernel path) arriving within the coalescing window join
it up to ``max_batch``, and the group dispatches through ONE padded
bucket executable of fixed capacity, its occupied lanes swept together.
A request's bits never depend on what it was co-batched with: a lane's
arithmetic reads its own slices alone (``serve.kernels``).

**Pipelined dispatch.** A padded dispatch leaves its result on the
device and joins a bounded in-flight ring (``ServeConfig.pipeline_depth``,
0 meaning 2); results are fetched — the blocking step — only when the
ring exceeds its depth, the queue goes idle or the service drains, or
before any other route's dispatch. The pad buffers are per-key
:class:`~.kernels.BucketTemplates`, reused across dispatches: their
``non_blocking`` uploads are pinned by a CUDA event the template waits
on before a lane is rewritten. Each dispatch is a pure function of its
own inputs, so the depth changes no bit. On the card the power loop
reads one flag back per sweep, so a dispatch holds the host until its
last sweep; the ring overlaps the result fetch and the next request's
padding only.

Four routes: ``bucket`` (the padded path, on the ring), ``cuda`` (the
``bucket_cuda`` low-latency class, one request at its exact shape, which
launches the Hopper kernels), ``direct`` (a per-request ``Oracle``
resolution: ineligible configurations, shapes beyond the ladders, the
numpy backend) and ``session`` (a named ``MarketSession``). The batcher
thread launches kernels but does not build them: the service builds
before the thread starts.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque

import numpy as np
import torch

from .. import obs
from ..faults import plan as _faults
from ..oracle import Oracle, assemble_result, record_consensus_result
from ..parallel.sharded import resolve_device
from . import kernels as sk
from .cache import BucketKey
from .cuda import CUDA_KERNEL_PATH, cuda_bucket_inputs
from .incremental import kernel_path_counter

__all__ = ["Microbatcher", "OCCUPANCY_BUCKETS", "DEFAULT_PIPELINE_DEPTH"]

#: batch-occupancy histogram edges (requests per padded dispatch)
OCCUPANCY_BUCKETS = (1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0, 32.0)

#: the depth ``pipeline_depth=0`` resolves to: the reference's default
#: without a tuning cache (its ``tune/`` is ROADMAP.md §A.12)
DEFAULT_PIPELINE_DEPTH = 2

#: keys of the flat light dict a lane must carry into assemble_result
_SCALAR_KEYS = ("iterations", "convergence", "percent_na",
                "avg_certainty")


def _scalars(flat: dict) -> dict:
    for k in _SCALAR_KEYS:
        flat[k] = np.asarray(flat[k]).item()
    return flat


class _Inflight:
    """One dispatched padded group awaiting retirement: the device
    results and what the host-side finish needs."""

    __slots__ = ("key", "path", "live", "raw")

    def __init__(self, key, path, live, raw) -> None:
        self.key = key
        self.path = path
        self.live = live
        self.raw = raw


class Microbatcher:
    """The dispatch engine: one daemon thread owning device dispatch on
    ``device`` (None: the card, raising without one) in ``dtype``. The
    parallelism that matters (lanes, the
    kernels' blocks) lives inside a dispatch."""

    def __init__(self, queue, cache, config, sessions, admission,
                 device=None, dtype: torch.dtype = None) -> None:
        self.queue = queue
        self.cache = cache
        self.config = config
        self.sessions = sessions
        self.admission = admission
        self.device = resolve_device(device)
        self.dtype = dtype or torch.get_default_dtype()
        self._thread = None
        #: the exception that ended the batcher thread (None: running)
        self.fatal = None
        self._requests = obs.counter(
            "pyconsensus_serve_requests_total",
            "serve requests by dispatch path and outcome",
            labels=("path", "outcome"))
        self._latency = obs.histogram(
            "pyconsensus_serve_request_seconds",
            "submit-to-result latency per request",
            labels=("path",))
        self._occupancy = obs.histogram(
            "pyconsensus_serve_batch_occupancy",
            "requests coalesced per bucketed dispatch",
            buckets=OCCUPANCY_BUCKETS)
        self._kernel_path = kernel_path_counter()
        self._ring: deque = deque()
        self._templates: OrderedDict = OrderedDict()
        depth = int(getattr(config, "pipeline_depth", 1) or 0)
        self._depth = max(1, depth or DEFAULT_PIPELINE_DEPTH)
        obs.gauge(
            "pyconsensus_serve_pipeline_depth",
            "configured dispatch pipeline depth (in-flight bucketed "
            "dispatches the batcher keeps before blocking on a "
            "fetch)").set(self._depth)
        self._inflight_gauge = obs.gauge(
            "pyconsensus_serve_inflight_dispatches",
            "bucketed dispatches currently in flight on the async "
            "dispatch ring")

    # -- lifecycle ------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run,
                                        name="pyconsensus-serve-batcher",
                                        daemon=True)
        self._thread.start()

    def join(self, timeout=None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)

    # -- the loop -------------------------------------------------------

    def _run(self) -> None:
        """The thread's body. A failure outside one request's dispatch
        (the loop itself) ends the thread: the queue closes and every
        request still queued gets the error, so no caller waits on a
        future nobody will resolve."""
        try:
            self._loop()
        except BaseException as exc:  # noqa: BLE001 — the futures carry it
            self.fatal = exc
            self.queue.close()
            for req in self.queue.drain_pending():
                if not req.future.done():
                    req.future.set_exception(exc)
            self._fail([r for inf in self._ring for r in inf.live], exc,
                       "bucket")
            self._ring.clear()
            raise

    def _loop(self) -> None:
        if self.device.type == "cuda" and self.device.index is not None:
            torch.cuda.set_device(self.device)
        while True:
            # with dispatches in flight poll fast: an idle tick is what
            # retires the ring's tail
            req = self.queue.take(timeout=0.002 if self._ring else 0.05)
            if req is None:
                self._drain_ring(0)
                if self.queue.closed:
                    return
                continue
            try:
                self._serve_one(req)
            except BaseException as exc:  # noqa: BLE001 — future carries it
                if not req.future.done():
                    req.future.set_exception(exc)

    def _serve_one(self, req) -> None:
        if req.expired():
            self.admission.record_shed("deadline")
            req.shed("deadline", waited_s=time.monotonic()
                     - req.submitted_at)
            self._requests.inc(path=req.dispatch_path, outcome="shed")
            return
        ring_path = (req.dispatch_path == "bucket"
                     and req.batch_key.kernel_path != CUDA_KERNEL_PATH)
        if not ring_path and self._ring:
            # another route's dispatch is a synchronization point: older
            # ring results retire first, or sustained direct/cuda/session
            # traffic could hold them back until their deadlines
            self._drain_ring(0)
        if req.dispatch_path == "bucket":
            group = [req] + self._coalesce(req)
            self._dispatch_bucket(group)
        elif req.dispatch_path == "session":
            self._dispatch_session(req)
        else:
            self._dispatch_direct(req)

    def _coalesce(self, first) -> list:
        """Collect same-key requests within the window, up to the key's
        batch capacity (the ``cuda`` class runs capacity 1)."""
        cap = min(self.config.max_batch, first.batch_key.batch) - 1
        if cap <= 0:
            return []
        window_end = time.monotonic() + self.config.batch_window_ms / 1e3
        group: list = []
        while len(group) < cap:
            group.extend(self.queue.take_matching(first.batch_key,
                                                  cap - len(group)))
            remaining = window_end - time.monotonic()
            if len(group) >= cap or remaining <= 0:
                break
            time.sleep(min(remaining, 5e-4))
        return group

    # -- dispatch routes ------------------------------------------------

    def _fail(self, reqs, exc, path: str) -> None:
        """Every waiter of a failed dispatch learns of it."""
        for r in reqs:
            if not r.future.done():
                r.future.set_exception(exc)
                self._requests.inc(path=path, outcome="error")

    def _dispatch_bucket(self, group) -> None:
        self._occupancy.observe(len(group))
        key: BucketKey = group[0].batch_key
        path = ("bucket_cuda" if key.kernel_path == CUDA_KERNEL_PATH
                else "bucket")
        live = [r for r in group if not r.expired()]
        for r in group:
            if r not in live:
                self.admission.record_shed("deadline")
                r.shed("deadline")
                self._requests.inc(path=path, outcome="shed")
        if not live:
            return
        if key.kernel_path == CUDA_KERNEL_PATH:
            self._dispatch_cuda(key, live)
            return
        try:
            _faults.fire("serve.dispatch")
            self._kernel_path.inc(len(live), path="plain")
            tmpl = self._template_for(key)
            for i, r in enumerate(live):
                tmpl.fill_lane(i, r.reports, r.reputation, r.scaled,
                               r.mins, r.maxs, has_na=key.params.has_na)
            entry = self.cache.get(key)
            with obs.span("serve.dispatch",
                          bucket=f"{key.rows}x{key.events}",
                          topology=key.topology, occupancy=len(live)):
                stacked = sk.place_bucket_operands(
                    tmpl, lanes=len(live) if key.batch > 1 else None)
                raw = entry(*stacked, key.params)
        except BaseException as exc:  # noqa: BLE001
            self._fail(live, exc, path)
            raise
        # the device results ride the ring; the fetch happens at _retire
        self._ring.append(_Inflight(key, path, live, raw))
        self._drain_ring(self._depth - 1)

    def _template_for(self, key: BucketKey):
        """The per-key pad template (LRU-bounded with the executable
        cache, so many buckets cannot grow host buffers without
        bound)."""
        tmpl = self._templates.get(key)
        if tmpl is None:
            tmpl = self._templates[key] = sk.BucketTemplates(
                key.rows, key.events, key.batch, dtype=self.dtype,
                device=self.device)
            while len(self._templates) > self.config.cache_capacity:
                self._templates.popitem(last=False)
        else:
            self._templates.move_to_end(key)
        return tmpl

    def _drain_ring(self, allowed: int) -> None:
        """Retire in-flight dispatches (oldest first) until at most
        ``allowed`` remain."""
        while len(self._ring) > allowed:
            self._retire(self._ring.popleft())
        self._inflight_gauge.set(len(self._ring))

    def _retire(self, inf: _Inflight) -> None:
        """Fetch one in-flight dispatch's results and resolve its
        waiters. A device-side failure surfaces here, on this group."""
        try:
            # one fetch a key for the whole dispatch, then the lanes
            host = {k: sk._host(v) for k, v in inf.raw.items()}
            if inf.key.batch > 1:
                lanes = [{k: v[i] for k, v in host.items()}
                         for i in range(len(inf.live))]
            else:
                lanes = [host]
            flats = [sk.slice_result(lane, r.shape[0], r.shape[1])
                     for lane, r in zip(lanes, inf.live)]
        except BaseException as exc:  # noqa: BLE001 — later dispatches
            # are independent and keep retiring
            self._fail(inf.live, exc, inf.path)
            return
        for flat, r in zip(flats, inf.live):
            result = assemble_result(_scalars(flat))
            result["quarantined_rows"] = r.quarantined_rows
            record_consensus_result(result, inf.key.params.algorithm,
                                    "serve")
            self._finish(r, result, inf.path)

    def _dispatch_cuda(self, key: BucketKey, live) -> None:
        """The ``bucket_cuda`` dispatch: per request, at its exact shape,
        through the fused pipeline (``serve.cuda``). Capacity is 1; a
        longer group is served one after another."""
        for i, r in enumerate(live):
            try:
                _faults.fire("serve.dispatch")
                self._kernel_path.inc(path="cuda")
                entry = self.cache.get(key)
                with obs.span("serve.dispatch",
                              bucket=f"{key.rows}x{key.events}",
                              topology=key.topology,
                              kernel_path=key.kernel_path, occupancy=1):
                    raw = entry(*cuda_bucket_inputs(r, self.device,
                                                    self.dtype),
                                key.params)
                    flat = {k: sk._host(v) for k, v in raw.items()}
            except BaseException as exc:  # noqa: BLE001 — the rest of
                # the group would otherwise hang to its timeouts
                self._fail(live[i:], exc, "bucket_cuda")
                raise
            result = assemble_result(_scalars(flat))
            result["quarantined_rows"] = r.quarantined_rows
            record_consensus_result(result, key.params.algorithm, "serve")
            self._finish(r, result, "bucket_cuda")

    def _dispatch_direct(self, req) -> None:
        _faults.fire("serve.dispatch")
        with obs.span("serve.direct", backend=req.backend,
                      shape=str(req.shape)):
            result = Oracle(reports=req.reports,
                            event_bounds=req.event_bounds,
                            reputation=req.reputation,
                            backend=req.backend,
                            device=(self.device if req.backend == "torch"
                                    else None),
                            **req.oracle_kwargs).consensus()
        result["quarantined_rows"] = req.quarantined_rows
        self._finish(req, result, "direct")

    def _dispatch_session(self, req) -> None:
        _faults.fire("serve.dispatch")
        session = self.sessions.get(req.session)
        with obs.span("serve.session", session=str(req.session)):
            flat = session.resolve(**req.oracle_kwargs)
        result = assemble_result(flat)
        result["quarantined_rows"] = np.array([], dtype=np.int64)
        # the incremental tier's resolves (warm ones and their exact
        # anchors) are labeled bucket_incremental
        path = ("bucket_incremental"
                if session.last_resolve_path
                in ("incremental", "incremental_exact") else "session")
        self._finish(req, result, path)

    def _finish(self, req, result, path: str) -> None:
        if not req.future.done():
            req.future.set_result(result)
            self._requests.inc(path=path, outcome="ok")
            self._latency.observe(
                time.monotonic() - req.submitted_at, path=path)
