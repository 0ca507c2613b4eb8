"""The port's kernel-build store (``pyconsensus_tpu_torch.serve.aotcache``),
its hook in ``ops/build.py``, ``ExecutableCache(aot=)``, the service's and
the fleet's ``warm_from_disk``, the compile monitor (``obs/compilemon.py``)
and the serve command line's ``--aot-cache``, on the CPU, mirroring
``tests/test_aotcache.py``:

- a key entry persists, adopts (counted under ``serve_bucket_aot``, its
  own ``serve_bucket*`` entry at 0) and serves the bits a fresh build
  serves; persist is idempotent, and a failed one is a warning;
- the corruption matrix, each refusal counted under its ``reason`` and
  the entry deleted: truncated, bit-flipped, a stale runtime fingerprint,
  a wrong ``BucketKey`` under a valid name, foreign magic, a garbage
  header, a fingerprint that is not an object, another format; an
  unreadable file refused as ``io`` and kept; a ``.aotx`` the reference's
  ``AotCache`` wrote on CPU jax refused without a crash;
- the two fault sites, a standby that warms from the store inside a
  takeover (plain-path keys on the CPU);
- the libraries: persisted and installed byte for byte into an empty
  build directory only after every digest matched (byte payloads: no
  ``dlopen`` on the CPU), a flipped byte refused as ``digest`` with
  nothing installed and the sources built again, no ``nvcc`` and no valid
  entry an error, two processes adopting into one directory at once.
"""

import hashlib
import json
import os
import shutil
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from pyconsensus_tpu_torch import faults, obs
from pyconsensus_tpu_torch.faults import AotCacheCorruptionError, FaultPlan
from pyconsensus_tpu_torch.models.pipeline import ConsensusParams
from pyconsensus_tpu_torch.obs import compilemon
from pyconsensus_tpu_torch.ops import build
from pyconsensus_tpu_torch.serve import (AOT_ENTRY, AotCache, BucketKey,
                                         ConsensusFleet, ConsensusService,
                                         ExecutableCache, FleetConfig,
                                         ServeConfig, warm_inputs)
from pyconsensus_tpu_torch.serve import aotcache
from pyconsensus_tpu_torch.serve.cuda import (CUDA_KERNEL_PATH,
                                              cuda_bucket_params)
from pyconsensus_tpu_torch.serve.incremental import INCREMENTAL_KERNEL_PATH

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, EVENTS = 8, 16


@pytest.fixture(autouse=True)
def float64():
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(prev)


def count(name, **labels):
    return obs.value(name, **labels) or 0


def key_of(rows=ROWS, events=EVENTS, path="plain", batch=2):
    if path == CUDA_KERNEL_PATH:
        p = cuda_bucket_params(True, {}, ())
    else:
        p = ConsensusParams(algorithm="sztorc", pca_method="power",
                            has_na=True)
    return BucketKey.make(rows, events, batch if path == "plain" else 1,
                          p, kernel_path=path)


def store(tmp_path, name="aot"):
    return AotCache(tmp_path / name, device="cpu")


def flat(out):
    return {k: np.asarray(v.cpu() if hasattr(v, "cpu") else v).tobytes()
            for k, v in out.items()}


@pytest.fixture
def fake_libs(tmp_path, monkeypatch):
    """A build directory holding stand-in library bytes under the real
    library names (no ``nvcc`` on the CPU)."""
    built = tmp_path / "built"
    built.mkdir()
    payloads = {}
    for i, src in enumerate(build.SOURCES):
        data = bytes((i * 37 + j) % 256 for j in range(4096 + i))
        (built / build.lib_name(src)).write_bytes(data)
        payloads[build.lib_name(src)] = data
    monkeypatch.setattr(build, "BUILD_DIR", built)
    return built, payloads


def empty_build_dir(tmp_path, monkeypatch, name="empty"):
    empty = tmp_path / name
    monkeypatch.setattr(build, "BUILD_DIR", empty)
    return empty


# -- key entries --------------------------------------------------------------


class TestKeyEntries:
    def test_persist_then_adopt(self, tmp_path):
        aot, key = store(tmp_path), key_of()
        assert not aot.has(key)
        written0 = count("pyconsensus_aot_persist_total", outcome="written")
        assert aot.persist(key) is True
        assert aot.has(key)
        assert count("pyconsensus_aot_persist_total",
                     outcome="written") == written0 + 1
        loaded0 = count("pyconsensus_aot_load_total", outcome="loaded")
        assert aot.adopt(key) == {"kernel_path": "plain", "kernels": None}
        assert count("pyconsensus_aot_load_total",
                     outcome="loaded") == loaded0 + 1

    def test_persist_is_idempotent(self, tmp_path):
        aot, key = store(tmp_path), key_of()
        assert aot.persist(key) is True
        before = aot.entry_path(key).read_bytes()
        exists0 = count("pyconsensus_aot_persist_total", outcome="exists")
        assert aot.persist(key) is False
        assert count("pyconsensus_aot_persist_total",
                     outcome="exists") == exists0 + 1
        assert aot.entry_path(key).read_bytes() == before

    def test_miss_is_counted(self, tmp_path):
        miss0 = count("pyconsensus_aot_load_total", outcome="miss")
        assert store(tmp_path).adopt(key_of()) is None
        assert count("pyconsensus_aot_load_total",
                     outcome="miss") == miss0 + 1

    def test_fingerprint_names_the_runtime(self, tmp_path):
        fp = aotcache.key_fingerprint(key_of(), "cpu")
        assert (fp["rows"], fp["events"], fp["batch"]) == (ROWS, EVENTS, 2)
        assert fp["kernel_path"] == "plain"
        rt = fp["runtime"]
        assert rt["generation"] == "cpu" and rt["dtype"] == "float64"
        assert rt["kernels"] == build.sources_digest()
        assert rt["torch"] == str(torch.__version__)
        name = aotcache.entry_filename(fp)
        assert len(name) == 24 + len(".aotx") and name.endswith(".aotx")
        assert aotcache.kernels_filename("ab") == "kernels-ab.aotk"

    def test_cuda_key_names_the_kernels(self, tmp_path):
        aot, key = store(tmp_path), key_of(path=CUDA_KERNEL_PATH)
        aot.persist(key)
        assert aot.adopt(key)["kernels"] == build.sources_digest()
        # on the CPU no library is persisted with it
        assert not aot.has_libraries()

    def test_cache_bytes_gauge_and_orphan_sweep(self, tmp_path):
        aot = store(tmp_path)
        aot.persist(key_of())
        assert obs.value("pyconsensus_aot_cache_bytes") == \
            aot.entry_path(key_of()).stat().st_size
        old = aot.dir / "x.tmp.aotx"
        young = aot.dir / "y.tmp.aotk"
        old.write_bytes(b"orphan")
        young.write_bytes(b"writer")
        os.utime(old, (1.0, 1.0))
        store(tmp_path)
        assert not old.exists() and young.exists()


# -- the corruption matrix ----------------------------------------------------


def _truncate(path, _):
    path.write_bytes(path.read_bytes()[:-3])


def _flip(path, _):
    raw = bytearray(path.read_bytes())
    raw[-2] ^= 0x01
    path.write_bytes(bytes(raw))


def _rewrite_header(path, edit):
    raw = path.read_bytes()
    magic = aotcache.AOT_MAGIC
    n = int.from_bytes(raw[len(magic):len(magic) + 8], "big")
    body = len(magic) + 8
    header = json.loads(raw[body:body + n])
    edit(header)
    hdr = json.dumps(header, sort_keys=True).encode()
    path.write_bytes(magic + len(hdr).to_bytes(8, "big") + hdr
                     + raw[body + n:])


def _stale_runtime(path, _):
    def edit(h):
        h["fingerprint"]["runtime"]["torch"] = "0.0.1"
    _rewrite_header(path, edit)


def _collision(path, aot):
    # another key's valid entry under this key's name
    other = key_of(rows=16)
    aot.persist(other)
    shutil.copyfile(aot.entry_path(other), path)


def _foreign_magic(path, _):
    path.write_bytes(b"\x7fELF" + path.read_bytes()[4:])


def _garbage_header(path, _):
    magic = aotcache.AOT_MAGIC
    junk = b"{not json"
    path.write_bytes(magic + len(junk).to_bytes(8, "big") + junk)


def _non_dict_fingerprint(path, _):
    def edit(h):
        h["fingerprint"] = ["rows", 8]
    _rewrite_header(path, edit)


def _format(path, _):
    def edit(h):
        h["format"] = 99
    _rewrite_header(path, edit)


CORRUPTIONS = {"truncated": (_truncate, "torn"),
               "bit-flipped": (_flip, "digest"),
               "stale-runtime": (_stale_runtime, "fingerprint"),
               "key-collision": (_collision, "fingerprint"),
               "foreign-magic": (_foreign_magic, "magic"),
               "garbage-header": (_garbage_header, "header"),
               "non-dict-fingerprint": (_non_dict_fingerprint,
                                        "fingerprint"),
               "format": (_format, "format")}


@pytest.mark.parametrize("how", sorted(CORRUPTIONS))
def test_corrupt_entry_refused_deleted_and_counted(tmp_path, how):
    corrupt, reason = CORRUPTIONS[how]
    aot, key = store(tmp_path), key_of()
    aot.persist(key)
    path = aot.entry_path(key)
    corrupt(path, aot)
    with pytest.raises(AotCacheCorruptionError) as ei:
        aot.verify(key)
    assert ei.value.error_code == "PYC302"
    assert ei.value.context["reason"] == reason
    rejected0 = count("pyconsensus_aot_reject_total", reason=reason)
    assert aot.adopt(key) is None
    assert count("pyconsensus_aot_reject_total",
                 reason=reason) == rejected0 + 1
    assert not path.exists()
    # the key builds and persists again
    assert aot.persist(key) and aot.adopt(key) is not None


def test_unreadable_entry_refused_and_kept(tmp_path):
    aot, key = store(tmp_path), key_of()
    aot.persist(key)
    io0 = count("pyconsensus_aot_reject_total", reason="io")
    plan = FaultPlan(seed=0, rules=[
        {"site": "aot.cache_load", "kind": "raise", "occurrences": [0],
         "args": {"error": "os_error"}}])
    with faults.armed(plan):
        assert aot.adopt(key) is None
    assert plan.fired == [("aot.cache_load", 0, "raise")]
    assert count("pyconsensus_aot_reject_total", reason="io") == io0 + 1
    assert aot.entry_path(key).exists()
    assert aot.adopt(key) is not None


def test_reference_entry_refused_without_a_crash(tmp_path):
    """A ``.aotx`` the reference's ``AotCache`` wrote on CPU jax (the same
    framing, a jax runtime and an XLA payload) under a port key's name is
    refused on its fingerprint and deleted."""
    from pyconsensus_tpu.serve import ConsensusService as RefService
    from pyconsensus_tpu.serve import ServeConfig as RefConfig

    ref_dir = tmp_path / "ref"
    svc = RefService(RefConfig(warmup=((ROWS, EVENTS),),
                               aot_cache_dir=str(ref_dir)))
    try:
        svc.warm_buckets()
    finally:
        svc.close(drain=False)
    ref_entries = sorted(ref_dir.glob("*.aotx"))
    assert ref_entries
    aot, key = store(tmp_path), key_of()
    shutil.copyfile(ref_entries[0], aot.entry_path(key))
    fp0 = count("pyconsensus_aot_reject_total", reason="fingerprint")
    assert aot.adopt(key) is None
    assert count("pyconsensus_aot_reject_total",
                 reason="fingerprint") == fp0 + 1
    assert not aot.entry_path(key).exists()


# -- fault sites --------------------------------------------------------------


def test_cache_write_torn_after_the_write_is_refused_at_load(tmp_path):
    aot, key = store(tmp_path), key_of()
    plan = FaultPlan(seed=0, rules=[
        {"site": "aot.cache_write", "kind": "torn_write",
         "occurrences": [0]}])
    with faults.armed(plan):
        assert aot.persist(key) is True
    assert plan.fired == [("aot.cache_write", 0, "torn_write")]
    with pytest.raises(AotCacheCorruptionError):
        aot.verify(key)
    assert aot.adopt(key) is None and not aot.has(key)


def test_failed_persist_is_fail_soft(tmp_path, capsys):
    aot, key = store(tmp_path), key_of()
    failed0 = count("pyconsensus_aot_persist_total", outcome="failed")
    plan = FaultPlan(seed=0, rules=[
        {"site": "aot.cache_write", "kind": "raise", "occurrences": [0],
         "args": {"error": "os_error"}}])
    with faults.armed(plan):
        assert aot.persist(key) is False
    assert count("pyconsensus_aot_persist_total",
                 outcome="failed") == failed0 + 1
    assert "WARNING" in capsys.readouterr().err


# -- the executable cache and the service -------------------------------------


class TestExecutableCache:
    @pytest.mark.parametrize("path", ["plain", INCREMENTAL_KERNEL_PATH,
                                      CUDA_KERNEL_PATH])
    def test_adopted_key_serves_the_built_bits(self, tmp_path, path):
        key = key_of(path=path)
        first = ExecutableCache(4, device="cpu", aot=store(tmp_path))
        first.warm(key)
        assert first.builds == 1 and first.adopted == 0
        aot0 = count("pyconsensus_serve_builds_total", entry=AOT_ENTRY)
        second = ExecutableCache(4, device="cpu", aot=store(tmp_path))
        second.warm(key)
        assert second.builds == 0 and second.adopted == 1
        assert count("pyconsensus_serve_builds_total",
                     entry=AOT_ENTRY) == aot0 + 1
        args = warm_inputs(key, "cpu")
        assert flat(first.get(key)(*args, key.params)) == \
            flat(second.get(key)(*args, key.params))

    def test_topology_gate_runs_before_the_store(self, tmp_path):
        key = BucketKey.make(ROWS, EVENTS, 2, key_of().params,
                             topology="mesh:other")
        cache = ExecutableCache(4, device="cpu", aot=store(tmp_path))
        miss0 = count("pyconsensus_aot_load_total", outcome="miss")
        with pytest.raises(ValueError, match="wrong-topology"):
            cache.get(key)
        assert count("pyconsensus_aot_load_total", outcome="miss") == miss0

    def test_refused_entry_builds_as_without_a_store(self, tmp_path):
        key = key_of()
        ExecutableCache(4, device="cpu", aot=store(tmp_path)).warm(key)
        _flip(store(tmp_path).entry_path(key), None)
        cache = ExecutableCache(4, device="cpu", aot=store(tmp_path))
        cache.warm(key)
        assert cache.builds == 1 and cache.adopted == 0
        assert store(tmp_path).adopt(key) is not None   # persisted again


def test_service_warm_from_disk_adopts_the_configured_keys(tmp_path):
    cfg = ServeConfig(warmup=((ROWS, EVENTS),), pallas_buckets=True,
                      pallas_warmup=((6, 12),),
                      aot_cache_dir=str(tmp_path / "aot"))
    first = ConsensusService(cfg, device="cpu")
    assert first.warm_from_disk() == 0
    assert first.warm_buckets() == 2
    first.close(drain=False)
    second = ConsensusService(cfg, device="cpu")
    keys = second.configured_keys()
    assert [k.kernel_path for k in keys] == ["plain", CUDA_KERNEL_PATH]
    assert second.warm_from_disk() == 2
    assert second.warm_from_disk() == 0         # cached now
    second.start(warmup=True)
    try:
        assert second.cache.builds == 0 and second.cache.adopted == 2
        got = second.submit(reports=np.eye(6, 12)).result(60)
        assert np.isfinite(np.asarray(got["agents"]["smooth_rep"])).all()
    finally:
        second.close(drain=True)
    assert ConsensusService(ServeConfig(), device="cpu").warm_from_disk() \
        == 0


def test_standby_warms_from_the_store_inside_a_takeover(tmp_path):
    cfg = ServeConfig(warmup=((ROWS, EVENTS),), batch_window_ms=1.0,
                      aot_cache_dir=str(tmp_path / "aot"))
    ConsensusService(cfg, device="cpu").warm_buckets()    # fills the store
    fleet = ConsensusFleet(FleetConfig(
        n_workers=2, log_dir=str(tmp_path / "log"), worker=cfg),
        device="cpu").start(warmup=False)
    try:
        fleet.create_session("mkt", n_reporters=ROWS)
        owner = fleet.owner_of("mkt")
        warms0 = count("pyconsensus_aot_takeover_warms_total")
        fleet.kill_worker(owner)
        standby = fleet.owner_of("mkt")
        assert standby != owner
        assert count("pyconsensus_aot_takeover_warms_total") == warms0 + 1
        assert fleet.workers[standby].service.cache.adopted == 1
        assert fleet.workers[standby].service.cache.builds == 0
    finally:
        fleet.close(drain=False)


# -- the kernel libraries -----------------------------------------------------


class TestLibraries:
    def test_persist_and_install_byte_for_byte(self, tmp_path, monkeypatch,
                                               fake_libs):
        built, payloads = fake_libs
        aot = store(tmp_path)
        assert aot.persist_libraries() is True
        assert aot.persist_libraries() is False         # idempotent
        empty = empty_build_dir(tmp_path, monkeypatch)
        assert aot.adopt_libraries(build.SOURCES) == list(build.SOURCES)
        for name, data in payloads.items():
            assert (empty / name).read_bytes() == data
        assert sorted(p.name for p in empty.iterdir()) == sorted(payloads)
        # installed only where missing
        assert aot.adopt_libraries(build.SOURCES) == []

    def test_header_records_each_library(self, tmp_path, fake_libs):
        _, payloads = fake_libs
        aot = store(tmp_path)
        aot.persist_libraries()
        raw = aot.kernels_path().read_bytes()
        n = int.from_bytes(raw[8:16], "big")
        header = json.loads(raw[16:16 + n])
        assert header["fingerprint"]["kernels"] == build.sources_digest()
        assert {m["name"]: m["sha256"] for m in header["libraries"]} == \
            {k: hashlib.sha256(v).hexdigest() for k, v in payloads.items()}
        assert "nvcc_version" in header

    def test_nothing_persisted_while_a_library_is_missing(self, tmp_path,
                                                          fake_libs):
        built, _ = fake_libs
        (built / build.lib_name(build.SOURCES[0])).unlink()
        aot = store(tmp_path)
        assert aot.persist_libraries() is False
        assert not aot.has_libraries()

    @pytest.mark.parametrize("member", [0, 1])
    def test_flipped_byte_refuses_only_its_library(self, tmp_path,
                                                   monkeypatch, fake_libs,
                                                   member):
        """A damaged library refuses the entry (``digest``, deleted) and
        is not installed; the library that matched its own digest is."""
        built, payloads = fake_libs
        aot = store(tmp_path)
        aot.persist_libraries()
        path = aot.kernels_path()
        raw = bytearray(path.read_bytes())
        # a byte inside library ``member`` of the payload
        sizes = [len(payloads[build.lib_name(s)]) for s in build.SOURCES]
        raw[len(raw) - sum(sizes) + sum(sizes[:member]) + 100] ^= 0x40
        path.write_bytes(bytes(raw))
        with pytest.raises(AotCacheCorruptionError) as ei:
            aot.verify_libraries()
        assert ei.value.context["reason"] == "digest"
        empty = empty_build_dir(tmp_path, monkeypatch)
        digest0 = count("pyconsensus_aot_reject_total", reason="digest")
        sound = [s for i, s in enumerate(build.SOURCES) if i != member]
        assert aot.adopt_libraries(build.SOURCES) == sound
        assert count("pyconsensus_aot_reject_total",
                     reason="digest") == digest0 + 1
        assert not path.exists()
        assert sorted(p.name for p in empty.iterdir()) == \
            sorted(build.lib_name(s) for s in sound)
        for src in sound:
            name = build.lib_name(src)
            assert (empty / name).read_bytes() == payloads[name]

    @pytest.mark.parametrize("how,reason", [
        ("truncated", "torn"), ("foreign-magic", "magic"),
        ("listing", "header"), ("other-sources", "fingerprint"),
        ("format", "format")])
    def test_library_entry_refusals(self, tmp_path, monkeypatch, fake_libs,
                                    how, reason):
        aot = store(tmp_path)
        aot.persist_libraries()
        path = aot.kernels_path()

        def listing(h):
            h["libraries"][0]["bytes"] = "many"

        def other(h):
            h["fingerprint"]["kernels"] = "0" * 16

        def fmt(h):
            h["format"] = 2

        {"truncated": lambda: _truncate(path, None),
         "foreign-magic": lambda: _foreign_magic(path, None),
         "listing": lambda: _rewrite_header(path, listing),
         "other-sources": lambda: _rewrite_header(path, other),
         "format": lambda: _rewrite_header(path, fmt)}[how]()
        with pytest.raises(AotCacheCorruptionError) as ei:
            aot.verify_libraries()
        assert ei.value.context["reason"] == reason
        empty = empty_build_dir(tmp_path, monkeypatch)
        rejected0 = count("pyconsensus_aot_reject_total", reason=reason)
        assert aot.adopt_libraries(build.SOURCES) == []
        assert count("pyconsensus_aot_reject_total",
                     reason=reason) == rejected0 + 1
        assert not path.exists()
        assert not empty.exists() or not any(empty.iterdir())

    def test_build_all_adopts_without_nvcc(self, tmp_path, monkeypatch,
                                           fake_libs):
        built, payloads = fake_libs
        aot = store(tmp_path)
        aot.persist_libraries()
        empty_build_dir(tmp_path, monkeypatch)

        def no_nvcc():
            raise RuntimeError("nvcc not found")

        monkeypatch.setattr(build, "nvcc_path", no_nvcc)
        events = []
        listener = lambda *e: events.append(e)      # noqa: E731
        build.add_listener(listener)
        previous = build.attach_store(aot)
        try:
            out = build.build_all()
        finally:
            build.attach_store(previous)
            build.remove_listener(listener)
        for src in build.SOURCES:
            assert out[src].read_bytes() == payloads[build.lib_name(src)]
        assert [(e, s) for e, s, _ in events] == \
            [("store_adopt", s) for s in build.SOURCES]

    def test_refused_entry_builds_the_same_sources(self, tmp_path,
                                                   monkeypatch, fake_libs):
        """A refused library never leads to a plain version: its source
        is built again (here a stand-in ``nvcc``), counted, the sound
        library is adopted, and the libraries are persisted again."""
        built, payloads = fake_libs
        aot = store(tmp_path)
        aot.persist_libraries()
        _flip(aot.kernels_path(), None)
        empty_build_dir(tmp_path, monkeypatch)
        ran = []

        def fake_nvcc(todo, out):
            for src in todo:
                out[src].write_bytes(payloads[build.lib_name(src)])
                build._SECONDS[src] = 0.5
            ran.extend(todo)

        monkeypatch.setattr(build, "_nvcc", fake_nvcc)
        registry = obs.MetricsRegistry()
        monkeypatch.setattr(compilemon, "_installed", [None])
        assert obs.install_compile_monitor(registry) is True
        previous = build.attach_store(aot)
        try:
            build.build_all()
        finally:
            build.attach_store(previous)
            build.remove_listener(compilemon._installed[0])
        # the flipped byte sits in the last library
        assert ran == [build.SOURCES[-1]]
        assert registry.value("pyconsensus_jax_compile_events_total",
                              event="nvcc") == 1
        assert registry.value("pyconsensus_jax_compile_seconds_total",
                              event="nvcc") == 0.5
        assert registry.value("pyconsensus_jax_compile_events_total",
                              event="store_adopt") == len(build.SOURCES) - 1
        assert aot.verify_libraries() == payloads     # persisted again

    def test_no_nvcc_and_no_valid_entry_raises(self, tmp_path, monkeypatch,
                                               fake_libs):
        aot = store(tmp_path)
        aot.persist_libraries()
        _truncate(aot.kernels_path(), None)
        empty_build_dir(tmp_path, monkeypatch)

        def no_nvcc():
            raise RuntimeError("nvcc not found")

        monkeypatch.setattr(build, "nvcc_path", no_nvcc)
        previous = build.attach_store(aot)
        try:
            with pytest.raises(RuntimeError, match="nvcc not found"):
                build.build_all()
        finally:
            build.attach_store(previous)

    def test_loaded_bytes_are_the_verified_bytes(self, tmp_path,
                                                 monkeypatch, fake_libs):
        """What ``ops/build.load`` hands ``ctypes.CDLL`` is a file whose
        bytes matched the entry's digest (the stand-in records the digest
        of the file at the moment it would be opened)."""
        built, payloads = fake_libs
        aot = store(tmp_path)
        aot.persist_libraries()
        empty_build_dir(tmp_path, monkeypatch)
        opened = {}

        class FakeLib:
            def __init__(self, path):
                opened[os.path.basename(path)] = hashlib.sha256(
                    open(path, "rb").read()).hexdigest()

            def __getattr__(self, name):
                return type("Fn", (), {})()

        monkeypatch.setattr(build.ctypes, "CDLL", FakeLib)
        monkeypatch.setattr(build, "_LIBS", {})
        monkeypatch.setattr(build, "nvcc_path", lambda: (_ for _ in ()
                                                         ).throw(
            RuntimeError("nvcc not found")))
        previous = build.attach_store(aot)
        try:
            for src in build.SOURCES:
                build.load(src)
        finally:
            build.attach_store(previous)
        assert opened == {k: hashlib.sha256(v).hexdigest()
                          for k, v in payloads.items()}

    def test_two_processes_adopt_into_one_directory(self, tmp_path,
                                                    fake_libs):
        """Two fresh processes from one copy of the package without a
        build directory adopt the same store at once: both succeed, the
        libraries are the entry's bytes and no temporary is left."""
        _, payloads = fake_libs
        aot = store(tmp_path)
        aot.persist_libraries()
        copy = tmp_path / "copy"
        shutil.copytree(os.path.join(REPO, "pyconsensus_tpu_torch"),
                        copy / "pyconsensus_tpu_torch",
                        ignore=shutil.ignore_patterns("build",
                                                      "__pycache__"))
        script = (
            "import sys; from pyconsensus_tpu_torch.ops import build; "
            "from pyconsensus_tpu_torch.serve.aotcache import AotCache; "
            f"a = AotCache({str(aot.dir)!r}, device='cpu'); "
            "print(a.adopt_libraries(build.SOURCES))")
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("JAX_", "XLA_"))}
        env["PYTHONPATH"] = str(copy)
        procs = [subprocess.Popen([sys.executable, "-c", script], env=env,
                                  cwd=str(copy), stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for _ in range(2)]
        outs = [p.communicate(timeout=120) for p in procs]
        assert [p.returncode for p in procs] == [0, 0], outs
        installed = [eval(o[0].strip().splitlines()[-1]) for o in outs]
        assert sorted(sum(installed, [])) in (sorted(build.SOURCES),
                                              sorted(build.SOURCES * 2))
        dest = copy / "pyconsensus_tpu_torch" / "csrc" / "build"
        assert sorted(p.name for p in dest.iterdir()) == sorted(payloads)
        for name, data in payloads.items():
            assert (dest / name).read_bytes() == data


# -- the compile monitor, the transport and the command line ------------------


def test_compile_monitor_is_idempotent_and_names_the_events(monkeypatch):
    registry = obs.MetricsRegistry()
    monkeypatch.setattr(compilemon, "_installed", [None])
    try:
        assert obs.install_compile_monitor(registry) is True
        listener = compilemon._installed[0]
        assert obs.install_compile_monitor(registry) is True
        assert compilemon._installed[0] is listener
        assert build._LISTENERS.count(listener) == 1
        for event in compilemon.COMPILE_EVENTS:
            build._emit(event, "resolve.cu", 0.25)
        for event in ("nvcc", "store_adopt", "library_load"):
            assert registry.value("pyconsensus_jax_compile_events_total",
                                  event=event) == 1.0
            assert registry.value("pyconsensus_jax_compile_seconds_total",
                                  event=event) == 0.25
    finally:
        build.remove_listener(compilemon._installed[0])


def test_supervisor_skips_the_build_when_the_store_holds_it(tmp_path,
                                                            monkeypatch,
                                                            fake_libs):
    from pyconsensus_tpu_torch.serve.transport import SocketTransport
    from pyconsensus_tpu_torch.serve.transport.supervisor import \
        WorkerSupervisor

    def boom():
        raise AssertionError("built although the store holds the kernels")

    aot = store(tmp_path)
    aot.persist_libraries()
    monkeypatch.setattr(build, "build_all", boom)
    WorkerSupervisor._prebuild(str(aot.dir))
    assert SocketTransport(aot_cache_dir=aot.dir).aot_cache_dir == aot.dir
    # without the libraries in the store the supervisor builds, with the
    # store attached so the build is persisted into it
    attached = []
    monkeypatch.setattr(build, "build_all",
                        lambda: attached.append(build.attached_store()))
    WorkerSupervisor._prebuild(str(tmp_path / "other"))
    assert attached and attached[0] is not None
    assert build.attached_store() is None


def test_worker_process_adopts_at_boot(tmp_path):
    """A worker process with an ``aot_cache_dir`` adopts the keys an
    earlier process warmed before ``READY``: its ``warm_from_disk`` RPC
    then answers 0 and its cache built nothing."""
    from pyconsensus_tpu_torch.serve.transport.rpc import RpcClient
    from pyconsensus_tpu_torch.serve.transport.supervisor import (
        WorkerProcess, worker_subprocess_env)
    from pyconsensus_tpu_torch.tune.fingerprint import runtime_fingerprint

    cfg = ServeConfig(warmup=((ROWS, EVENTS),), batch_window_ms=1.0,
                      aot_cache_dir=str(tmp_path / "aot"))
    ConsensusService(cfg, device="cpu").warm_buckets()
    cmd = [sys.executable, "-m",
           "pyconsensus_tpu_torch.serve.transport.worker", "--name", "w0",
           "--log-root", str(tmp_path / "log"), "--device", "cpu",
           "--dtype", "float64", "--config-json",
           json.dumps(cfg.__dict__)]
    proc = WorkerProcess("w0", cmd, worker_subprocess_env())
    try:
        port = proc.wait_ready(120.0)
        c = RpcClient("127.0.0.1", port, label="w0",
                      expect_fingerprint=runtime_fingerprint("cpu"))
        assert c.call("warm_from_disk") == {"adopted": 0}
        stats = c.call("stats")
        assert stats["adopted"] == 1 and stats["builds"] == 0
        assert stats["compile_events"] == {e: 0 for e in
                                           compilemon.COMPILE_EVENTS}
        c.close()
    finally:
        proc.terminate(timeout_s=30.0)
    assert proc.proc.returncode == 0


def test_cli_aot_cache_adopts_on_the_second_run(tmp_path, capsys):
    from pyconsensus_tpu_torch.serve import cli

    argv = ["--device", "cpu", "--warmup-only", "--shapes", "12x48",
            "--aot-cache", str(tmp_path / "aot"), "--metrics-out",
            str(tmp_path / "m.prom")]
    assert cli.main(argv) == 0
    first = json.loads(capsys.readouterr().out)
    assert first["builds"] == 1
    assert cli.main(argv) == 0
    second = json.loads(capsys.readouterr().out)
    assert second["builds"] == 0
    # the counters are the process's: the second run adopted one key and
    # wrote nothing
    assert second["aot_loaded"] == (first["aot_loaded"] or 0) + 1
    assert second["aot_persisted"] == first["aot_persisted"] >= 1
    assert compilemon._installed[0] in build._LISTENERS


def test_cli_load_run_reports_the_store(tmp_path, capsys):
    from pyconsensus_tpu_torch.serve import cli

    assert cli.main(["--device", "cpu", "--requests", "4", "--shapes",
                     "12x48", "--aot-cache", str(tmp_path / "aot")]) == 0
    stats = json.loads(capsys.readouterr().out)
    assert "aot_loaded" in stats and stats["aot_persisted"] >= 1
    assert stats["failed"] == 0


def test_concurrent_warms_persist_one_entry(tmp_path):
    key = key_of()
    caches = [ExecutableCache(4, device="cpu", aot=store(tmp_path))
              for _ in range(4)]
    threads = [threading.Thread(target=c.warm, args=(key,)) for c in caches]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60.0)
    entries = sorted(p.name for p in (tmp_path / "aot").iterdir())
    assert entries == [store(tmp_path).entry_path(key).name]
    assert store(tmp_path).adopt(key) is not None
