"""The port's out-of-core driver (``pyconsensus_tpu_torch.parallel.
streaming_consensus``) against the JAX package's ``streaming_consensus``
on the CPU, on the corpus of ``tests/test_streaming.py``.

The reference runs under ``JAX_PLATFORMS=cpu`` with x64 (the conftest);
the port runs with ``device="cpu"``, in float64 and again in float32.

- float64: snapped outcomes, ``na_row``, ``iterations`` and
  ``convergence`` exact; every continuous key within 1e-9; the first
  loading within 1e-8 up to sign (``canon_sign`` follows rounding where
  the loading's largest entries tie).
- float32 against the reference's float64: continuous keys within 1e-5,
  2e-3 for fixed-variance and ica (the orthogonal bands of
  ``tests/test_torch_multi.py``); snapped outcomes exact.
- Above a monkeypatched ``STREAM_EIGH_MAX_R`` both packages take the
  orthogonal iteration from the same start block, so they agree to 1e-8
  (ica 1e-6: FastICA amplifies the iteration's last bits).
- Several hosts on threads, summing through the reference's rendezvous
  (``contrib[0] + contrib[1] + ...``), equal one host.
"""

import threading
import types

import numpy as np
import pytest
import torch

from conftest import collusion_reports
from pyconsensus_tpu import faults as ref_faults
from pyconsensus_tpu.models.pipeline import ConsensusParams as RefParams
from pyconsensus_tpu.parallel import streaming as ref_st
from pyconsensus_tpu_torch import ConsensusParams, faults, io, obs
from pyconsensus_tpu_torch.models import clustering as cl
from pyconsensus_tpu_torch.parallel import streaming as st
from pyconsensus_tpu_torch.parallel import streaming_consensus

ALGORITHMS = ("sztorc", "fixed-variance", "ica", "k-means", "hierarchical",
              "dbscan", "dbscan-jit")
EXACT_KEYS = ("outcomes_adjusted", "outcomes_final", "na_row", "iterations",
              "convergence")
CONT_KEYS = ("smooth_rep", "this_rep", "old_rep", "certainty",
             "consensus_reward", "participation_rows",
             "participation_columns", "reporter_bonus", "author_bonus",
             "na_bonus_rows", "na_bonus_cols", "outcomes_raw",
             "avg_certainty", "percent_na")
F64_ATOL = 1e-9
LOADING_ATOL = 1e-8
#: float32 against float64: the kernel band, and the orthogonal band of
#: the multi-component algorithms
F32_ATOL = {"fixed-variance": 2e-3, "ica": 2e-3}


@pytest.fixture
def float64():
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(prev)


@pytest.fixture
def float32():
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float32)
    yield
    torch.set_default_dtype(prev)


def params(algorithm="sztorc", **kw):
    return (ConsensusParams(algorithm=algorithm, **kw),
            RefParams(algorithm=algorithm, **kw))


def both(reports, algorithm="sztorc", panel_events=7, **kw):
    """``(port, reference)`` results of one streamed resolution."""
    p, rp = params(algorithm, **kw)
    port = streaming_consensus(reports, panel_events=panel_events, params=p,
                               device="cpu")
    ref = ref_st.streaming_consensus(reports, panel_events=panel_events,
                                     params=rp)
    return port, ref


def assert_match(got, ref, atol=F64_ATOL, loading_atol=LOADING_ATOL):
    for k in EXACT_KEYS:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]),
                                      err_msg=k)
    for k in CONT_KEYS:
        np.testing.assert_allclose(np.asarray(got[k], float),
                                   np.asarray(ref[k], float), atol=atol,
                                   rtol=0, err_msg=k)
    assert ("first_loading" in got) == ("first_loading" in ref)
    if "first_loading" in ref:
        np.testing.assert_allclose(np.abs(got["first_loading"]),
                                   np.abs(np.asarray(ref["first_loading"])),
                                   atol=loading_atol, rtol=0)
    assert ("ica_converged" in got) == ("ica_converged" in ref)
    if "ica_converged" in ref:
        assert got["ica_converged"] == ref["ica_converged"]


def corpus(seed=0, R=18, E=23, liars=5, na_frac=0.1):
    return collusion_reports(np.random.default_rng(seed), R=R, E=E,
                             liars=liars, na_frac=na_frac)[0]


# -- float64 against the reference ------------------------------------------


@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("panel_events", [4, 7, 64])
def test_every_algorithm_and_panel_width(float64, algorithm, panel_events):
    """Ragged last panels (4, 7 on E = 23) and a panel wider than E."""
    port, ref = both(corpus(), algorithm, panel_events, num_clusters=3)
    assert_match(port, ref)


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_three_iterations(float64, algorithm):
    """One accumulation pass an executed iteration (k-means: its Lloyd
    passes again under the iterating reputation), the iteration count and
    the convergence flag."""
    port, ref = both(corpus(1, R=20, E=17, na_frac=0.08), algorithm, 5,
                     max_iterations=3, convergence_tolerance=1e-3,
                     num_clusters=3)
    assert_match(port, ref)


def test_kmeans_several_iterations(float64):
    port, ref = both(corpus(2), "k-means", 6, max_iterations=4,
                     num_clusters=3)
    assert_match(port, ref)
    assert "first_loading" not in port


def test_sztorc_to_convergence(float64):
    port, ref = both(corpus(3, R=20, E=17, na_frac=0.08), "sztorc", 5,
                     max_iterations=25, convergence_tolerance=1e-3)
    assert_match(port, ref)
    assert port["convergence"]


@pytest.mark.parametrize("algorithm", ["sztorc", "fixed-variance",
                                       "k-means"])
def test_scaled_events(float64, algorithm):
    rng = np.random.default_rng(4)
    reports, _ = collusion_reports(rng, R=12, E=10, liars=3)
    reports[:, 8:] = rng.uniform(0.0, 50.0, size=(12, 2))
    bounds = [None] * 8 + [{"scaled": True, "min": 0.0, "max": 50.0}] * 2
    p, rp = params(algorithm)
    port = streaming_consensus(reports, event_bounds=bounds, panel_events=3,
                               params=p, device="cpu")
    ref = ref_st.streaming_consensus(reports, event_bounds=bounds,
                                     panel_events=3, params=rp)
    assert_match(port, ref)


def test_reputation_prior(float64):
    reports = corpus(5)
    rep = np.random.default_rng(5).random(reports.shape[0]) + 0.1
    p, rp = params("sztorc", max_iterations=2)
    port = streaming_consensus(reports, reputation=rep, panel_events=6,
                               params=p, device="cpu")
    ref = ref_st.streaming_consensus(reports, reputation=rep,
                                     panel_events=6, params=rp)
    assert_match(port, ref)


@pytest.mark.parametrize("algorithm", ["sztorc", "fixed-variance", "ica"])
def test_orth_iter_spectrum_above_eigh_cap(float64, algorithm, monkeypatch):
    """Above ``STREAM_EIGH_MAX_R`` the spectrum comes from ``_sym_topk``
    in both packages (the port counts each in
    ``pyconsensus_streaming_topk_fallback_total``)."""
    monkeypatch.setattr(st, "STREAM_EIGH_MAX_R", 4)
    monkeypatch.setattr(ref_st, "STREAM_EIGH_MAX_R", 4)
    before = obs.value("pyconsensus_streaming_topk_fallback_total") or 0
    port, ref = both(corpus(6), algorithm, 7)
    assert obs.value("pyconsensus_streaming_topk_fallback_total") \
        == before + 1
    assert_match(port, ref, atol=1e-6 if algorithm == "ica" else 1e-8,
                 loading_atol=1e-6)


# -- float32 bands -----------------------------------------------------------


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_float32_band(float32, algorithm):
    reports = corpus(7)
    p, rp = params(algorithm, max_iterations=2, num_clusters=3)
    port = streaming_consensus(reports, panel_events=7, params=p,
                               device="cpu")
    ref = ref_st.streaming_consensus(reports, panel_events=7, params=rp)
    atol = F32_ATOL.get(algorithm, 1e-5)
    assert_match(port, ref, atol=atol, loading_atol=atol)
    assert port["smooth_rep"].dtype == np.float64       # host results


# -- sources ------------------------------------------------------------------


def test_npy_path_and_memmap(float64, tmp_path):
    reports = corpus(8, R=16, E=12, liars=4)
    path = io.save_reports(tmp_path / "big.npy", reports)
    ref = ref_st.streaming_consensus(reports, panel_events=5)
    for src in (path, str(path), np.load(path, mmap_mode="r")):
        out = streaming_consensus(src, panel_events=5, device="cpu")
        assert_match(out, ref)


def test_float32_npy_source_cast_once(float64, tmp_path):
    """A float32 file resolves as its values cast to the working dtype."""
    reports = corpus(9, R=16, E=12, liars=4).astype(np.float32)
    path = tmp_path / "f32.npy"
    np.save(path, reports)
    out = streaming_consensus(path, panel_events=5, device="cpu")
    ref = ref_st.streaming_consensus(reports.astype(np.float64),
                                     panel_events=5)
    assert_match(out, ref)


def test_csv_stages_beside_source_and_is_removed(float64, tmp_path,
                                                 monkeypatch):
    reports = corpus(10, R=16, E=12, liars=4)
    src = io.save_reports(tmp_path / "big.csv", reports)
    ref = ref_st.streaming_consensus(reports, panel_events=5)
    staged_at = []
    real = io.csv_to_npy

    def spy(src_p, dst_p, **kw):
        staged_at.append(dst_p)
        return real(src_p, dst_p, **kw)

    monkeypatch.setattr(io, "csv_to_npy", spy)
    assert_match(streaming_consensus(src, panel_events=5, device="cpu"), ref)
    assert staged_at[0].parent == tmp_path
    other = tmp_path / "elsewhere"
    other.mkdir()
    assert_match(streaming_consensus(src, panel_events=5, staging_dir=other,
                                     device="cpu"), ref)
    assert staged_at[1].parent == other
    assert list(tmp_path.glob("*-stage-*")) == []
    assert list(other.glob("*-stage-*")) == []


def test_failed_staging_removes_the_file(float64, tmp_path):
    src = tmp_path / "bad.csv"
    src.write_text("1,0,1\n0,1\n1,1,1\n")                    # ragged row
    with pytest.raises(ValueError):
        streaming_consensus(src, panel_events=2, device="cpu")
    assert [f.name for f in tmp_path.iterdir()] == ["bad.csv"]


def test_unwritable_source_dir_falls_back_to_tempdir(float64, tmp_path,
                                                     monkeypatch):
    reports = corpus(11, R=10, E=6, liars=2)
    src = io.save_reports(tmp_path / "r.csv", reports)
    elsewhere = tmp_path / "tmp"
    elsewhere.mkdir()
    real = st.tempfile.mkstemp

    def mkstemp(dir=None, **kw):
        if dir is not None:
            raise PermissionError(dir)
        return real(dir=str(elsewhere), **kw)

    # the driver's own view of the module: csv_to_npy's staging stays real
    monkeypatch.setattr(st, "tempfile", types.SimpleNamespace(
        mkstemp=mkstemp))
    out = streaming_consensus(src, panel_events=4, device="cpu")
    assert_match(out, ref_st.streaming_consensus(reports, panel_events=4))
    assert list(elsewhere.iterdir()) == []
    with pytest.raises(PermissionError):      # an explicit dir must work
        streaming_consensus(src, panel_events=4, staging_dir=tmp_path,
                            device="cpu")


# -- several hosts on threads -------------------------------------------------


def run_hosts(reports, p, n_hosts, panel_events):
    """Resolve on ``n_hosts`` threads with the reference's rendezvous
    allreduce (``contrib[0] + contrib[1] + ...``); a barrier timeout turns
    a host that skips a collective into an error in every peer."""
    bar = threading.Barrier(n_hosts, timeout=60)
    contrib, summed, results, errors = {}, {}, {}, []

    def make_allreduce(i):
        def allreduce(x):
            contrib[i] = np.asarray(x)
            bar.wait()
            if i == 0:
                summed["v"] = sum(contrib[j] for j in range(n_hosts))
            bar.wait()
            out = summed["v"]
            bar.wait()
            return out
        return allreduce

    def host(i):
        try:
            results[i] = streaming_consensus(
                reports, panel_events=panel_events, params=p, host_id=i,
                n_hosts=n_hosts, allreduce=make_allreduce(i), device="cpu")
        except Exception as exc:           # surface a host's failure
            errors.append(exc)
            bar.abort()

    threads = [threading.Thread(target=host, args=(i,), daemon=True)
               for i in range(n_hosts)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    assert not any(t.is_alive() for t in threads), "a host thread hung"
    return results


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_two_hosts_equal_one(float64, algorithm):
    reports = corpus(12, R=16, E=23, liars=4)
    p = ConsensusParams(algorithm=algorithm, max_iterations=3)
    plain = streaming_consensus(reports, panel_events=4, params=p,
                                device="cpu")
    for res in run_hosts(reports, p, 2, 4).values():
        assert_match(res, plain)


@pytest.mark.parametrize("algorithm", ["sztorc", "k-means"])
def test_more_hosts_than_panels(float64, algorithm):
    """A host with no panel (3 hosts, 2 panels) still joins every
    reduction with zeros."""
    reports = corpus(13, R=12, E=23, liars=3)
    p = ConsensusParams(algorithm=algorithm, max_iterations=2)
    plain = streaming_consensus(reports, panel_events=16, params=p,
                                device="cpu")
    results = run_hosts(reports, p, 3, 16)
    assert len(results) == 3
    for res in results.values():
        assert_match(res, plain)


# -- validation, device, faults and observability ------------------------------


def test_validation_errors(float64):
    reports = corpus(14, R=8, E=6, liars=2)
    with pytest.raises(ValueError, match="unknown algorithm"):
        streaming_consensus(reports, params=ConsensusParams(
            algorithm="nonsense"), device="cpu")
    with pytest.raises(ValueError, match="panel_events"):
        streaming_consensus(reports, panel_events=0, device="cpu")
    with pytest.raises(ValueError, match="2-D"):
        streaming_consensus(reports[0], device="cpu")
    with pytest.raises(ValueError, match="host_id"):
        streaming_consensus(reports, host_id=5, n_hosts=2, device="cpu")
    # the default reduction needs a process group of n_hosts processes
    with pytest.raises(ValueError, match="process"):
        streaming_consensus(reports, host_id=0, n_hosts=2, device="cpu")
    with pytest.raises(ValueError, match="allreduce"):
        streaming_consensus(reports, allreduce=lambda x: x, device="cpu")
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md §A\.10"):
        streaming_consensus(reports, mesh=("cpu", "cpu"), device="cpu")


def test_no_device_means_the_card(monkeypatch):
    """``device=None`` is the card: without one the call raises, and
    nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        streaming_consensus(corpus(15, R=8, E=6, liars=2))


def test_nan_storm_panels_match_reference(float64):
    """One plan poisons the same cells of the same panels in both
    packages: more missing data, resolved finitely and alike."""
    reports = np.random.default_rng(0).choice([0.0, 1.0], size=(12, 32))
    rules = [{"site": "streaming.panel", "kind": "nan_storm",
              "max_fires": 0, "occurrences": [0, 1, 2, 3],
              "args": {"fraction": 0.2}}]
    with faults.armed(faults.FaultPlan(seed=1, rules=rules)) as plan:
        port = streaming_consensus(reports, panel_events=8, device="cpu")
    with ref_faults.armed(ref_faults.FaultPlan(seed=1, rules=rules)):
        ref = ref_st.streaming_consensus(reports, panel_events=8)
    assert [s for s, _, _ in plan.fired] == ["streaming.panel"] * 4
    assert np.isfinite(port["smooth_rep"]).all()
    assert_match(port, ref)


def test_inf_storm_fails_loudly(float64):
    reports = np.random.default_rng(0).choice([0.0, 1.0], size=(12, 32))
    with faults.armed(faults.FaultPlan(seed=1, rules=[
            {"site": "streaming.panel", "kind": "inf_storm",
             "occurrences": [0], "args": {"fraction": 0.05}}])):
        out = streaming_consensus(reports, panel_events=8, device="cpu")
    assert not np.isfinite(out["smooth_rep"]).all()


def test_raise_in_a_panel_joins_the_prefetch_thread(float64):
    """An armed raise at the third panel propagates, and the prefetch
    worker does not outlive the call."""
    before = threading.active_count()
    with faults.armed(faults.FaultPlan(seed=0, rules=[
            {"site": "streaming.panel", "kind": "raise",
             "occurrences": [2], "args": {"error": "os_error"}}])):
        with pytest.raises(OSError):
            streaming_consensus(corpus(16), panel_events=4, device="cpu")
    assert threading.active_count() == before


def test_spans_and_counters(float64):
    obs.reset()
    streaming_consensus(corpus(17), panel_events=7, device="cpu",
                        params=ConsensusParams(max_iterations=2,
                                               convergence_tolerance=0.0))
    names = [e["name"] for e in obs.events()]
    assert names.count("streaming.consensus") == 1
    assert names.count("streaming.accumulate_pass") == 2
    assert names.count("streaming.resolve_pass") == 1
    root = [e for e in obs.events() if e["name"] == "streaming.consensus"][0]
    assert root["attrs"]["panel_events"] == 7
    assert root["attrs"]["multihost"] is False
    # 4 panels: two accumulation passes and the resolve pass
    assert obs.value("pyconsensus_streaming_panels_total") == 12
    assert obs.value("pyconsensus_consensus_total", algorithm="sztorc",
                     backend="streaming", converged="false") == 1
    obs.reset()


def test_dbscan_jit_given_distances_equal_computed(float64):
    """The driver hands dbscan-jit the S-derived distances; given or
    computed, the conformity is the same."""
    X = np.random.default_rng(18).random((12, 7))
    rep = torch.full((12,), 1.0 / 12)
    Xt = torch.as_tensor(X)
    direct = cl.dbscan_jit_conformity(Xt, rep, 0.8, 2)
    given = cl.dbscan_jit_conformity(torch.zeros((12, 0)), rep, 0.8, 2,
                                     sq_dists=cl.pairwise_sq_dists(Xt))
    np.testing.assert_array_equal(direct.numpy(), given.numpy())


_GATHER_SCRIPT = """
import sys
import numpy as np
import torch
from pyconsensus_tpu_torch.parallel import distributed as d

d.GATHER_BYTES = 48            # slices of 3 float64 or 6 float32 values
rank = int(sys.argv[2])
d.initialize(sys.argv[1], 2, rank, device="cpu")
x = np.random.default_rng(rank).random((3, 7))
t = torch.as_tensor(np.random.default_rng(10 + rank).random((2, 9)),
                    dtype=torch.float32)
print(d.allreduce_sum(x).tobytes().hex())
print(d.allreduce_sum(t).numpy().tobytes().hex())
"""


def test_allreduce_sum_slices_in_host_order():
    """Two gloo processes; ``allreduce_sum`` gathers in slices of
    ``GATHER_BYTES`` and each host gets ``x_0 + x_1`` bit for bit, for a
    numpy array (float64) and a float32 tensor."""
    import os
    import subprocess
    import sys

    from conftest import free_port

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    address = f"localhost:{free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _GATHER_SCRIPT, address, str(i)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=repo) for i in range(2)]
    runs = []
    try:
        for proc in procs:
            runs.append(proc.communicate(timeout=120))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for proc, (out, err) in zip(procs, runs):
        assert proc.returncode == 0, out + err
    xs = [np.random.default_rng(r).random((3, 7)) for r in range(2)]
    ts = [np.random.default_rng(10 + r).random((2, 9)).astype(np.float32)
          for r in range(2)]
    want = [(xs[0] + xs[1]).tobytes().hex(),
            (ts[0] + ts[1]).tobytes().hex()]
    for out, _ in runs:
        assert out.split() == want


@pytest.mark.parametrize("local_rank,process_id,cards,card",
                         [(None, 5, 4, 1), ("2", 7, 4, 2), (None, 3, 8, 3)])
def test_initialize_takes_the_local_card(monkeypatch, local_rank,
                                         process_id, cards, card):
    """Under NCCL each process takes its own card: ``LOCAL_RANK`` where it
    is set, else ``process_id`` modulo the host's cards."""
    from pyconsensus_tpu_torch.parallel import distributed

    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert distributed._local_card(process_id) == card
