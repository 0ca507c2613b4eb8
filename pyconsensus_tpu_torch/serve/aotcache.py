"""The kernel-build store: a verified, persisted store of the kernel
libraries and of the bucket keys that were warmed
(``pyconsensus_tpu/serve/aotcache.py``).

The reference persists each warmed bucket's XLA executable, so a
restarted or standby process serves without retracing. The port compiles
nothing for each key: its one compile is the kernel libraries
(``ops/build.py``, ``nvcc`` on every ``csrc/*.cu``, about two minutes).
So the store holds two kinds of entry in one directory:

- **one entry for each warmed** ``BucketKey``, ``<24 hex>.aotx``, named
  by the digest of its fingerprint (:func:`key_fingerprint`: the six key
  dimensions plus ``tune.fingerprint.runtime_fingerprint``: the package,
  torch and its CUDA version, the device generation, the default dtype
  and the kernel sources' digest). Its payload records what the key
  needs (the kernel digest for a ``cuda`` key); a key of the padded,
  incremental or sharded path compiles nothing, and its entry records
  only that the key was warmed, so that ``warm_from_disk`` knows what to
  warm;
- **one entry of the kernel libraries for each sources digest**,
  ``kernels-<digest>.aotk``: each ``.so`` under its ``ops/build`` name
  with its SHA-256 (and, for the record, ``nvcc --version``).

Both are framed as the reference's entries: magic, an 8-byte big-endian
header length, header JSON, payload. Verify before adopt: a torn,
truncated, foreign, incompatible or digest-mismatched entry is refused
with :class:`~pyconsensus_tpu_torch.faults.AotCacheCorruptionError`
(PYC302) naming its ``reason`` (``magic``, ``torn``, ``header``,
``format``, ``fingerprint``, ``digest``), counted and deleted; an
unreadable file (``OSError``) is refused without being deleted
(``reason="io"``). No library byte is installed, and so none reaches
``ctypes.CDLL``, before that library matched its own SHA-256: a verified
library is written into ``BUILD_DIR`` under its own name by
``io.atomic_write``, only where that name is missing, and
``ops/build.load`` then finds it and runs no ``nvcc``. A library whose
digest does not match refuses the entry (``reason="digest"``, deleted)
while the libraries that matched are still installed; every other
refusal installs nothing. A refused library leads to an ``nvcc`` build of
its source, which is counted
(``pyconsensus_jax_compile_events_total{event="nvcc"}``) and persisted
again; never to a plain version.

Counters: ``pyconsensus_aot_persist_total{outcome}`` (written, exists,
failed: a failed persist is a warning, never an error),
``pyconsensus_aot_load_total{outcome}`` (loaded, miss),
``pyconsensus_aot_reject_total{reason}`` and the gauge
``pyconsensus_aot_cache_bytes``; they count both kinds of entry. Fault
sites: ``aot.cache_write`` fires after an entry's atomic write,
``aot.cache_load`` before its read.
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import struct
import subprocess
import sys
import time

from .. import io as pio
from .. import obs
from ..faults import AotCacheCorruptionError
from ..faults import plan as _faults

__all__ = ["AotCache", "AOT_ENTRY", "AOT_MAGIC", "key_fingerprint",
           "entry_filename", "kernels_filename"]

#: the build counter's entry label of a key adopted from the store (its
#: own ``serve_bucket*`` entry stays at 0 after a restart)
AOT_ENTRY = "serve_bucket_aot"

AOT_MAGIC = b"PYCAOT1\n"
_FORMAT = 1
#: header length bound: anything larger is a torn or foreign file
_MAX_HEADER = 1 << 20
#: temporaries older than this are orphans of a killed writer
_ORPHAN_AGE_S = 3600.0


def _params_fields(p) -> dict:
    """``ConsensusParams`` as a JSON-stable field map (the params
    dimension of the fingerprint)."""
    return {k: (v if isinstance(v, (bool, int, float, str, type(None)))
                else repr(v))
            for k, v in p._asdict().items()}


def key_fingerprint(key, device=None) -> dict:
    """The full compatibility fingerprint of ``key``'s entry on
    ``device`` (None: the card): the six ``BucketKey`` dimensions plus
    the runtime fingerprint. Equality is the adopt condition."""
    from ..tune.fingerprint import runtime_fingerprint

    return {
        "rows": int(key.rows),
        "events": int(key.events),
        "batch": int(key.batch),
        "params": _params_fields(key.params),
        "topology": str(key.topology),
        "kernel_path": str(key.kernel_path),
        "runtime": runtime_fingerprint(device),
    }


def _canonical(fp: dict) -> bytes:
    return json.dumps(fp, sort_keys=True,
                      separators=(",", ":")).encode("utf-8")


def entry_filename(fp: dict) -> str:
    """A key entry's file name: the first 24 hex digits of its
    fingerprint's digest (the header's fingerprint is still verified: a
    renamed file must not pass under a valid name)."""
    return hashlib.sha256(_canonical(fp)).hexdigest()[:24] + ".aotx"


def kernels_filename(digest: str) -> str:
    """The kernel libraries' entry of sources digest ``digest``."""
    return f"kernels-{digest}.aotk"


def _libraries_fingerprint() -> dict:
    """What a libraries entry must match: this checkout's sources digest
    (sources, headers and compiler flags) and its library names."""
    from ..ops import build

    return {"kernels": build.sources_digest(),
            "libraries": [build.lib_name(src) for src in build.SOURCES]}


def _pack(header: dict, payload: bytes) -> bytes:
    hdr = json.dumps(header, sort_keys=True).encode("utf-8")
    return AOT_MAGIC + struct.pack(">Q", len(hdr)) + hdr + payload


def _nvcc_version():
    """``nvcc --version`` for the record (None without an ``nvcc``)."""
    from ..ops import build

    try:
        return subprocess.run([build.nvcc_path(), "--version"],
                              capture_output=True, text=True, timeout=60,
                              check=True).stdout.strip()
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return None


class AotCache:
    """The on-disk store (module docstring) for ``device`` (None: the
    card; it enters the key fingerprint). Every write is atomic; every
    read verifies before anything is adopted. Callers serialize through
    ``ExecutableCache``'s and ``ops/build``'s locks; processes sharing a
    directory race only on renames of identical bytes."""

    def __init__(self, path, device=None) -> None:
        self.dir = pathlib.Path(path).expanduser()
        self.dir.mkdir(parents=True, exist_ok=True)
        self.device = device
        self._persists = obs.counter(
            "pyconsensus_aot_persist_total",
            "kernel-store persist attempts by outcome (written / exists "
            "/ failed; failures are fail-soft)", labels=("outcome",))
        self._loads = obs.counter(
            "pyconsensus_aot_load_total",
            "kernel-store consults by outcome (loaded = adopted without "
            "a build; miss = no entry for this fingerprint)",
            labels=("outcome",))
        self._rejects = obs.counter(
            "pyconsensus_aot_reject_total",
            "kernel-store entries refused by verify-before-adopt (each "
            "is deleted and rebuilt, never loaded)", labels=("reason",))
        self._bytes = obs.gauge(
            "pyconsensus_aot_cache_bytes",
            "total bytes of the kernel store's entries on disk")
        self._sweep_orphans()
        self._update_bytes()

    # -- bookkeeping ----------------------------------------------------

    def _sweep_orphans(self) -> None:
        """Remove the temporaries a killed writer left (``atomic_write``
        cleans up only when its process survives); only old ones, since a
        young one may be a live writer's in a shared directory."""
        now = time.time()
        for pattern in ("*.tmp.aotx", "*.tmp.aotk"):
            for f in sorted(self.dir.glob(pattern)):
                try:
                    if now - f.stat().st_mtime > _ORPHAN_AGE_S:
                        f.unlink()
                except OSError:
                    continue

    def _update_bytes(self) -> None:
        try:
            total = sum(f.stat().st_size
                        for pattern in ("*.aotx", "*.aotk")
                        for f in sorted(self.dir.glob(pattern))
                        if ".tmp." not in f.name)
        except OSError:
            return
        self._bytes.set(total)

    def entry_path(self, key) -> pathlib.Path:
        return self.dir / entry_filename(key_fingerprint(key, self.device))

    def kernels_path(self) -> pathlib.Path:
        from ..ops import build

        return self.dir / kernels_filename(build.sources_digest())

    def has(self, key) -> bool:
        """Whether a (possibly invalid) entry exists for ``key``: the
        cheap probe of ``warm_from_disk``."""
        return self.entry_path(key).exists()

    def has_libraries(self) -> bool:
        """Whether a (possibly invalid) libraries entry exists for this
        checkout's sources digest."""
        return self.kernels_path().exists()

    def _write(self, path: pathlib.Path, blob: bytes, suffix: str) -> None:
        pio.atomic_write(path, lambda tmp: pathlib.Path(tmp).write_bytes(
            blob), suffix=suffix)
        # after the write: a torn_write rule models damage between this
        # persist and a later load, a raise kind a failed write
        _faults.fire("aot.cache_write", path=path)

    def _fail_soft(self, what: str, exc: BaseException) -> None:
        print(f"WARNING: persisting {what} into the kernel store failed "
              f"({type(exc).__name__}: {exc}); serving continues without "
              f"the entry", file=sys.stderr)
        self._persists.inc(outcome="failed")

    # -- persist --------------------------------------------------------

    def persist(self, key) -> bool:
        """Record that ``key`` was warmed (and, for a ``cuda`` key, keep
        the kernel libraries). Idempotent (an existing entry is kept) and
        fail-soft. Returns True iff a new key entry was written."""
        from ..ops import build
        from ..parallel.sharded import resolve_device
        from .cuda import CUDA_KERNEL_PATH

        if key.kernel_path == CUDA_KERNEL_PATH \
                and resolve_device(self.device).type == "cuda":
            # the libraries this process loaded for the key
            self.persist_libraries()
        path = self.entry_path(key)
        if path.exists():
            self._persists.inc(outcome="exists")
            return False
        try:
            fp = key_fingerprint(key, self.device)
            payload = json.dumps(
                {"kernel_path": str(key.kernel_path),
                 "kernels": (build.sources_digest()
                             if key.kernel_path == CUDA_KERNEL_PATH
                             else None)}, sort_keys=True).encode("utf-8")
            header = {"format": _FORMAT, "fingerprint": fp,
                      "payload_sha256": hashlib.sha256(payload).hexdigest(),
                      "payload_bytes": len(payload), "entry": AOT_ENTRY}
            self._write(path, _pack(header, payload), ".tmp.aotx")
        except Exception as exc:   # noqa: BLE001 — fail-soft by contract
            self._fail_soft(f"bucket key {tuple(key)!r}", exc)
            return False
        self._persists.inc(outcome="written")
        self._update_bytes()
        return True

    def persist_libraries(self) -> bool:
        """Keep this checkout's kernel libraries, read from
        ``BUILD_DIR``, as one entry. Idempotent and fail-soft; nothing is
        written while a library is missing. Returns True iff an entry was
        written."""
        from ..ops import build

        path = self.kernels_path()
        if path.exists():
            self._persists.inc(outcome="exists")
            return False
        try:
            libs = []
            for src in build.SOURCES:
                lib = build.BUILD_DIR / build.lib_name(src)
                if not lib.exists():
                    return False
                libs.append((src, lib.name, lib.read_bytes()))
            payload = b"".join(data for _, _, data in libs)
            # each library carries its own digest, so one damaged library
            # refuses only itself
            header = {
                "format": _FORMAT, "kind": "kernels",
                "fingerprint": _libraries_fingerprint(),
                "libraries": [{"source": src, "name": name,
                               "sha256": hashlib.sha256(data).hexdigest(),
                               "bytes": len(data)}
                              for src, name, data in libs],
                "payload_bytes": len(payload),
                "nvcc_version": _nvcc_version()}
            self._write(path, _pack(header, payload), ".tmp.aotk")
        except Exception as exc:   # noqa: BLE001 — fail-soft by contract
            self._fail_soft("the kernel libraries", exc)
            return False
        self._persists.inc(outcome="written")
        self._update_bytes()
        return True

    # -- verify ---------------------------------------------------------

    @staticmethod
    def _unframe(path: pathlib.Path, data: bytes) -> tuple:
        """``(header, payload)`` of one framed entry; refuses a bad
        magic, a torn frame, an unparseable header, another format and a
        payload of the wrong length."""
        if len(data) < len(AOT_MAGIC) + 8 or not data.startswith(AOT_MAGIC):
            raise AotCacheCorruptionError(
                f"{path}: not a kernel-store entry (bad magic: torn, "
                f"truncated or foreign file)", reason="magic",
                path=str(path))
        (hdr_len,) = struct.unpack_from(">Q", data, len(AOT_MAGIC))
        body = len(AOT_MAGIC) + 8
        if hdr_len > _MAX_HEADER or body + hdr_len > len(data):
            raise AotCacheCorruptionError(
                f"{path}: truncated header (file torn at {len(data)} "
                f"bytes)", reason="torn", path=str(path))
        try:
            header = json.loads(data[body:body + hdr_len])
        except ValueError as exc:
            raise AotCacheCorruptionError(
                f"{path}: unparseable entry header ({exc})",
                reason="header", path=str(path)) from exc
        if not isinstance(header, dict):
            raise AotCacheCorruptionError(
                f"{path}: entry header is not an object", reason="header",
                path=str(path))
        if header.get("format") != _FORMAT:
            raise AotCacheCorruptionError(
                f"{path}: entry format {header.get('format')!r} != "
                f"{_FORMAT} (written by an incompatible release)",
                reason="format", path=str(path))
        payload = data[body + hdr_len:]
        if len(payload) != header.get("payload_bytes"):
            raise AotCacheCorruptionError(
                f"{path}: payload is {len(payload)} bytes, header "
                f"promised {header.get('payload_bytes')}: file torn",
                reason="torn", path=str(path))
        return header, payload

    @staticmethod
    def _check_fingerprint(path, header: dict, expected: dict) -> None:
        found = header.get("fingerprint")
        if not isinstance(found, dict):
            found = {}          # valid JSON of the wrong shape: refused
        if found != expected:
            drift = sorted(k for k in set(expected) | set(found)
                           if found.get(k) != expected.get(k))
            raise AotCacheCorruptionError(
                f"{path}: compatibility fingerprint mismatch in {drift}: "
                f"persisted for a different {'/'.join(drift)}, never "
                f"adopted", reason="fingerprint", path=str(path),
                fields=drift, found={k: found.get(k) for k in drift},
                expected={k: expected.get(k) for k in drift})

    @staticmethod
    def _check_digest(path, payload: bytes, want) -> None:
        digest = hashlib.sha256(payload).hexdigest()
        if digest != want:
            raise AotCacheCorruptionError(
                f"{path}: payload SHA-256 {digest[:12]}… does not match "
                f"the header's {str(want)[:12]}…: content corrupted on "
                f"disk", reason="digest", path=str(path))

    def verify(self, key) -> dict:
        """Read and verify ``key``'s entry without adopting it: returns
        its payload dict; raises ``AotCacheCorruptionError`` (PYC302)
        naming the refusing check, ``FileNotFoundError`` on a miss."""
        path = self.entry_path(key)
        _faults.fire("aot.cache_load", path=path)
        header, payload = self._unframe(path, path.read_bytes())
        self._check_fingerprint(path, header,
                                key_fingerprint(key, self.device))
        self._check_digest(path, payload, header.get("payload_sha256"))
        try:
            return json.loads(payload)
        except ValueError as exc:
            raise AotCacheCorruptionError(
                f"{path}: entry payload does not decode ({exc})",
                reason="deserialize", path=str(path)) from exc

    def _libraries(self) -> tuple:
        """Read the libraries entry: ``(verified, refused)``, the
        ``{library name: bytes}`` of every library that matched its
        SHA-256, and the refusal of the first that did not (None). Any
        other damage raises as :meth:`verify`."""
        path = self.kernels_path()
        _faults.fire("aot.cache_load", path=path)
        header, payload = self._unframe(path, path.read_bytes())
        self._check_fingerprint(path, header, _libraries_fingerprint())
        members = header.get("libraries")
        if not isinstance(members, list) or not all(
                isinstance(m, dict) and isinstance(m.get("bytes"), int)
                and m["bytes"] >= 0 for m in members):
            raise AotCacheCorruptionError(
                f"{path}: entry header does not list its libraries",
                reason="header", path=str(path))
        names = sorted(str(m.get("name")) for m in members)
        if sum(m["bytes"] for m in members) != len(payload) or \
                names != sorted(_libraries_fingerprint()["libraries"]):
            raise AotCacheCorruptionError(
                f"{path}: the listed libraries do not tile the payload",
                reason="torn", path=str(path))
        verified, refused, at = {}, None, 0
        for member in members:
            data = payload[at:at + member["bytes"]]
            at += member["bytes"]
            try:
                self._check_digest(path, data, member.get("sha256"))
            except AotCacheCorruptionError as exc:
                refused = refused or exc
                continue
            verified[str(member["name"])] = data
        return verified, refused

    def verify_libraries(self) -> dict:
        """Read and verify the libraries entry: returns ``{library name:
        bytes}`` once every library matched its SHA-256; raises as
        :meth:`verify`."""
        verified, refused = self._libraries()
        if refused is not None:
            raise refused
        return verified

    # -- adopt ----------------------------------------------------------

    def _refuse(self, path: pathlib.Path, exc: BaseException) -> None:
        """Count, log and (unless the file was merely unreadable) delete
        a refused entry."""
        if isinstance(exc, AotCacheCorruptionError):
            reason = exc.context.get("reason", "unknown")
            print(f"WARNING: refusing kernel-store entry {path.name} "
                  f"({exc}); deleting it, the build runs again",
                  file=sys.stderr)
            self._rejects.inc(reason=reason)
            path.unlink(missing_ok=True)
            self._update_bytes()
        else:
            # an unreadable file is no evidence of corruption: refused
            # now, verified again next time
            print(f"WARNING: kernel-store entry {path.name} unreadable "
                  f"({type(exc).__name__}: {exc}); building instead",
                  file=sys.stderr)
            self._rejects.inc(reason="io")

    def adopt(self, key):
        """The payload of ``key``'s verified entry, or None on a miss or
        a refusal (counted, logged, deleted): the caller then builds."""
        path = self.entry_path(key)
        if not path.exists():
            self._loads.inc(outcome="miss")
            return None
        try:
            payload = self.verify(key)
        except FileNotFoundError:
            self._loads.inc(outcome="miss")
            return None
        except (OSError, AotCacheCorruptionError) as exc:
            self._refuse(path, exc)
            return None
        self._loads.inc(outcome="loaded")
        return payload

    def adopt_libraries(self, sources) -> list:
        """Install the verified libraries of ``sources`` whose names are
        missing from ``BUILD_DIR`` (``ops/build.build_all`` asks before
        any ``nvcc``). Returns the sources installed; a miss or a refused
        entry installs nothing, except that a library which matched its
        own digest is installed when another did not."""
        from ..ops import build

        path = self.kernels_path()
        if not path.exists():
            self._loads.inc(outcome="miss")
            return []
        try:
            libs, refused = self._libraries()
        except FileNotFoundError:
            self._loads.inc(outcome="miss")
            return []
        except (OSError, AotCacheCorruptionError) as exc:
            self._refuse(path, exc)
            return []
        if refused is not None:
            self._refuse(path, refused)
        installed = []
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        for src in sources:
            name = build.lib_name(src)
            target = build.BUILD_DIR / name
            if name not in libs or target.exists():
                continue            # refused, or another process's
            data = libs[name]
            pio.atomic_write(target, lambda tmp, data=data: pathlib.Path(  # consensus-lint: disable=CL802 — adoption runs under build._LOCK by design: build_all re-reads which libraries exist right after, so the install and that check are one step
                tmp).write_bytes(data), suffix=".tmp.so")
            installed.append(src)
        if refused is None:
            self._loads.inc(outcome="loaded")
        return installed
