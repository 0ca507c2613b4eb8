"""The event mesh across processes, over gloo on the CPU, against the
port's one-controller mesh and the JAX package.

``tests/torch_mesh_worker.py`` is started once a layout (a module fixture
a layout, each rank's output in a log file), each rank under a timeout: 2 ranks x 2 CPU shards, 4 ranks x 1 and a group of one rank
over 4 shards (the CPU's counterpart of the card's NCCL group of one).
Every rank runs the cases of ``torch_mesh_worker.CASES`` on
``make_process_mesh`` (the reference worker's phases 1, 4, 5 and 6,
``tests/distributed_worker.py``, at its 12 x 16 size, and fixed-variance,
ica, k-means, dbscan-jit, dbscan and ``ShardedOracle(mesh=)``), then two
of them on ``make_hybrid_mesh(batch=2)``'s row of the rank.

- Every rank's result equals the one-controller ``["cpu"] * 4`` mesh's
  bit for bit (a grid row: the ``["cpu"] * 2`` mesh's): the process
  mesh folds every shard's partial in global shard order.
- That result stays within the bands the one-controller mesh tests hold
  against the reference's in-process 4-device mesh
  (``tests/test_torch_mesh.py``, ``test_torch_mesh_scaled.py``,
  ``test_torch_mesh_plain.py``): outcomes and iterations exact.

Also here: ``make_hybrid_mesh`` and ``num_slices`` on the reference's
fake topologies (``tests/test_ring.py`` ``TestHybridMesh``), the
refusals of the consumers that do not run on a process mesh yet
(``ROADMAP.md`` §A.10), and the process mesh's own errors.
"""

import os
import pathlib
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import torch_mesh_worker as worker
from conftest import free_port
from pyconsensus_tpu.models.pipeline import ConsensusParams as RefParams
from pyconsensus_tpu.oracle import parse_event_bounds as ref_parse_bounds
from pyconsensus_tpu.parallel import ShardedOracle as RefShardedOracle
from pyconsensus_tpu.parallel import make_mesh as ref_make_mesh
from pyconsensus_tpu.parallel import sharded_consensus as ref_sharded
from pyconsensus_tpu_torch.parallel.distributed import (make_hybrid_mesh,
                                                        make_process_mesh,
                                                        num_slices)
from pyconsensus_tpu_torch.parallel.mesh import (DeviceGrid, ProcessMesh,
                                                 make_mesh, mesh_shape)
from test_torch_mesh import ATOL, assert_matches, reference
from test_torch_mesh_plain import ORTH_ATOL, assert_close
from test_torch_mesh_scaled import assert_scaled_matches

REPO = pathlib.Path(__file__).resolve().parent.parent
#: (ranks, CPU shards a rank)
LAYOUTS = [(2, 2), (4, 1), (1, 4)]
#: seconds a layout's ranks may take together
TIMEOUT = 180
LAYOUT_IDS = [f"{n}x{s}" for n, s in LAYOUTS]
#: the bands against the reference (module docstring): the dense matrix
#: keeps float32 storage through the products (``ROADMAP.md`` §C)
DENSE_ATOL = 1e-6
PLAIN_ATOL = 1e-9
CASES = sorted(worker.CASES)


def run_ranks(cmds, logs, timeout):
    """Start every command, its output to its log file; wait for all.
    When one fails, or the time is up, kill the others (a peer would
    wait in a collective) and fail with the failed ranks' logs."""
    procs = []
    for cmd, log in zip(cmds, logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(cmd, stdout=f,
                                          stderr=subprocess.STDOUT,
                                          cwd=REPO))
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            failed = [p for p in procs if p.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    assert not bad, "\n".join(
        f"--- rank {r} exited {procs[r].returncode} (killed after "
        f"{timeout} s or when a peer failed)\n{logs[r].read_text()[-4000:]}"
        for r in bad)


@pytest.fixture(scope="module")
def layout(request):
    """(ranks, CPU shards a rank), parametrised by each test."""
    return request.param


@pytest.fixture(scope="module")
def runs(layout, tmp_path_factory):
    """The layout's ranks, started together: every rank's results, in
    rank order. A fixture a layout, so that a failed layout fails only
    its own cases."""
    from pyconsensus_tpu_torch import _native

    _native.load()          # built once, before any rank needs it
    n, s = layout
    out = tmp_path_factory.mktemp(f"ranks{n}x{s}")
    address = f"localhost:{free_port()}"
    cmds = [[sys.executable, str(REPO / "tests" / "torch_mesh_worker.py"),
             address, str(n), str(r), str(s), str(out)] for r in range(n)]
    env_threads = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        run_ranks(cmds, [out / f"rank{r}.log" for r in range(n)], TIMEOUT)
    finally:
        if env_threads is None:
            os.environ.pop("OMP_NUM_THREADS")
        else:
            os.environ["OMP_NUM_THREADS"] = env_threads
    results = []
    for r in range(n):
        with open(out / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


_ONE = {}


def one_controller(name, shards=4):
    """The case on the one-controller mesh of ``shards`` CPU shards."""
    if (name, shards) not in _ONE:
        _ONE[name, shards] = worker.run_case(
            name, make_mesh(devices=["cpu"] * shards))
    return _ONE[name, shards]


def assert_bits(got, want, what):
    assert set(got) == set(want), what
    for key, a in want.items():
        np.testing.assert_array_equal(np.asarray(got[key]), a,
                                      err_msg=f"{what}: {key}")


@pytest.mark.parametrize("layout", LAYOUTS, ids=LAYOUT_IDS,
                         indirect=True)
@pytest.mark.parametrize("name", CASES)
def test_every_rank_equals_one_controller(runs, name, layout):
    """Every rank's result, bit for bit the one-controller 4-shard
    mesh's."""
    want = one_controller(name)
    for r, run in enumerate(runs):
        assert_bits(run[name], want, f"rank {r} of {layout}")


def _oracle_nested(flat):
    out = {"agents": {}, "events": {}}
    for key, v in flat.items():
        group, _, sub = key.partition(".")
        if sub:
            out[group][sub] = v
        else:
            out[key] = v
    return out


def _reference(name):
    """The reference's result of case ``name`` on its 4-device CPU mesh,
    and the comparison that holds the port to it."""
    (reports, rep, bounds), params, how = worker.CASES[name]
    if how == "oracle" and params.get("storage_dtype") == "int8":
        # the reference opens its fused (int8) path on a TPU only: its
        # fused mesh called as tests/test_torch_mesh.py calls it
        ref = reference(reports, rep, 4, "int8",
                        params["max_iterations"])

        def check(got):
            nested = _oracle_nested(got)
            for key, a in ref.items():
                for group in ("agents", "events"):
                    if key in nested[group]:
                        assert_matches({key: nested[group][key]}, {key: a})
            assert int(nested["iterations"]) == int(ref["iterations"])
        return check
    if how == "oracle":
        from test_torch_oracle import assert_oracles_match

        ref = RefShardedOracle(backend="jax", reports=reports.astype(
            np.float64), reputation=rep, event_bounds=bounds,
            mesh=ref_make_mesh(batch=1, event=4), **params).consensus()
        return lambda got: assert_oracles_match(_oracle_nested(got), ref,
                                                bounds, atol=PLAIN_ATOL)
    if params.get("pca_method") == "power" and params["algorithm"] == \
            "sztorc" and params.get("allow_fused", True):
        storage = params.get("storage_dtype", "")
        ref = reference(reports, rep, 4, storage, params["max_iterations"],
                        bounds=bounds)
        if bounds is None:
            return lambda got: assert_matches(got, ref, ATOL)
        scaled = ref_parse_bounds(bounds, 16)[0]
        return lambda got: assert_scaled_matches(got, ref, scaled)
    ref = ref_sharded(reports, reputation=rep, event_bounds=bounds,
                      mesh=ref_make_mesh(batch=1, event=4),
                      params=RefParams(**params))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    dense = not np.isnan(reports).any()
    orth = (params["algorithm"] in ("fixed-variance", "ica")
            and params.get("pca_method") == "power")
    atol = DENSE_ATOL if dense else ORTH_ATOL if orth else PLAIN_ATOL
    return lambda got: assert_close(got, ref, atol)


_REF = {}


@pytest.mark.parametrize("layout", LAYOUTS, ids=LAYOUT_IDS,
                         indirect=True)
@pytest.mark.parametrize("name", CASES)
def test_matches_reference_mesh(runs, name, layout):
    """Rank 0's result against the reference's 4-device mesh, in the
    one-controller mesh tests' bands."""
    if name not in _REF:
        _REF[name] = _reference(name)
    _REF[name](runs[0][name])


@pytest.mark.parametrize("layout", LAYOUTS, ids=LAYOUT_IDS,
                         indirect=True)
@pytest.mark.parametrize("name", worker.GRID_CASES)
def test_grid_row_equals_its_event_mesh(runs, name, layout):
    """On ``make_hybrid_mesh(batch=2)`` one matrix resolves on the row of
    each rank (2 shards): bit for bit the one-controller 2-shard mesh,
    on every rank."""
    want = one_controller(name, shards=2)
    for r, run in enumerate(runs):
        assert_bits(run[f"grid:{name}"], want, f"rank {r} of {layout}")


@pytest.mark.parametrize("layout", LAYOUTS, ids=LAYOUT_IDS,
                         indirect=True)
def test_layout_in_a_group(runs, layout):
    """One host: one slice; ``make_hybrid_mesh()`` is the process mesh;
    ``batch=2`` gives a 2 x 2 grid whose rows split the ranks' shards in
    order."""
    n, s = layout
    ranks = [r for r in range(n) for _ in range(s)]
    for run in runs:
        lay = run["layout"]
        assert int(lay["num_slices"]) == 1
        assert bool(lay["hybrid_is_process_mesh"])
        assert list(lay["grid_shape"]) == [2, 2]
        assert lay["rows"].tolist() == [ranks[:2], ranks[2:]]


# -- make_hybrid_mesh and num_slices on fake topologies (tests/test_ring.py
# TestHybridMesh) -------------------------------------------------------------


class FakeDev:
    def __init__(self, i, s):
        self.id, self.slice_index = i, s

    def __repr__(self):
        return f"d{self.id}s{self.slice_index}"


class TestHybridMesh:
    def test_single_slice_falls_back(self):
        """Outside a process group: one slice, the flat mesh."""
        assert num_slices() == 1
        m = make_hybrid_mesh(devices=["cpu"] * 8)
        assert mesh_shape(m) == (1, 8)
        m = make_hybrid_mesh(batch=2, devices=["cpu"] * 8)
        assert m.shape == {"batch": 2, "event": 4}

    def test_multi_slice_layout(self):
        """A 2-slice x 4-chip topology: event neighbours in one slice,
        the batch axis across slices."""
        devs = [FakeDev(i, i // 4) for i in range(8)]
        assert num_slices(devs) == 2
        m = make_hybrid_mesh(devices=devs)
        assert isinstance(m, DeviceGrid)
        grid = np.asarray(m.rows, dtype=object)
        assert grid.shape == (2, 4)
        for row in grid:
            assert len({d.slice_index for d in row}) == 1

    def test_multi_slice_subdivided_batch(self):
        devs = [FakeDev(i, i // 4) for i in range(8)]
        grid = np.asarray(make_hybrid_mesh(batch=4, devices=devs).rows,
                          dtype=object)
        assert grid.shape == (4, 2)
        for row in grid:
            assert len({d.slice_index for d in row}) == 1

    def test_bad_batch_rejected(self):
        devs = [FakeDev(i, i // 4) for i in range(8)]
        with pytest.raises(ValueError, match="multiple of the slice"):
            make_hybrid_mesh(batch=3, devices=devs)

    def test_uneven_slices_rejected(self):
        devs = [FakeDev(i, 0 if i < 5 else 1) for i in range(8)]
        with pytest.raises(ValueError, match="uneven chips per slice"):
            make_hybrid_mesh(devices=devs)


# -- errors and refusals ------------------------------------------------------


def test_process_mesh_needs_a_group():
    with pytest.raises(RuntimeError, match="process group"):
        make_process_mesh(["cpu"] * 2)


def test_process_mesh_without_a_card_raises():
    """``devices=None`` is this rank's card: without one it raises, and a
    rank never falls back to the CPU."""
    from pyconsensus_tpu_torch.parallel import distributed

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed._local_devices(None)


def test_ranks_of_different_device_types_raise(monkeypatch):
    """The one exchange of a mesh's construction refuses ranks whose
    devices are of different types."""
    from pyconsensus_tpu_torch.parallel import distributed

    class Group:
        @staticmethod
        def get_world_size():
            return 2

        @staticmethod
        def all_gather_object(out, mine):
            out[:] = [mine, (["cuda:0"], "h", "cuda")]

    monkeypatch.setattr(distributed, "_group", lambda: Group)
    with pytest.raises(ValueError, match="different types"):
        distributed._members((torch.device("cpu"),))


def _fake_process_mesh():
    """A process mesh's object, no group behind it: the refusals read its
    type alone."""
    return ProcessMesh([torch.device("cpu")], [0, 1], [1, 1], ["h", "h"], 0)


@pytest.mark.parametrize("consumer", ["ring", "simulator", "serve",
                                      "serve_executable", "streaming"])
def test_consumers_refuse_a_process_mesh(consumer):
    """The consumers queued in ``ROADMAP.md`` §A.10 raise a ValueError
    naming it when handed a process mesh."""
    from pyconsensus_tpu_torch import streaming_consensus
    from pyconsensus_tpu_torch.models.pipeline import ConsensusParams
    from pyconsensus_tpu_torch.parallel import ring_gram
    from pyconsensus_tpu_torch.serve import ConsensusService, ServeConfig
    from pyconsensus_tpu_torch.serve.sharded import \
        make_sharded_bucket_executable
    from pyconsensus_tpu_torch.sim import CollusionSimulator

    pm = _fake_process_mesh()
    x = np.zeros((4, 8))
    call = {
        "ring": lambda: ring_gram(x, pm),
        "simulator": lambda: CollusionSimulator(mesh=pm),
        "serve": lambda: ConsensusService(ServeConfig(sharded_buckets=True),
                                          devices=pm),
        "serve_executable": lambda: make_sharded_bucket_executable(
            ConsensusParams(pca_method="power"), pm),
        "streaming": lambda: streaming_consensus(x, mesh=pm),
    }[consumer]
    with pytest.raises(ValueError, match=r"ROADMAP\.md §A\.10"):
        call()
