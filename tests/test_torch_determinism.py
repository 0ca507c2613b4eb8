"""The port's Layer 6 (``pyconsensus_tpu_torch.analysis.determinism``)
on the CPU: the trigger/no-trigger corpus for CL1001-CL1004 (unordered
iteration, completion order, host nondeterminism, float accumulation —
including the sanitizers and the interprocedural category threading),
CL1005 as a source rule (a planted float ``atomicAdd`` in a CUDA corpus
file and a planted ``index_add_`` fire; ``std::atomic<int>`` and integer
atomics stay silent; the shipped ``csrc`` is clean), the live
package-is-clean invariant, the runtime DigestWitness over the port's
``ReplicationLog``/``ReputationLedger``/``mechanism_digest`` (green over
real durable-session operations, a tampered digest and a reordered fold
both flagged naming the op and BOTH digests), the shuffled-directory
bit-identical replay, the ``--format sarif`` output schema, and parity
with the reference's analyzer on every planted snippet."""

import io
import json
import pathlib
import shutil
import textwrap

import numpy as np
import pytest
import torch

from pyconsensus_tpu.analysis.determinism import \
    analyze_determinism as ref_analyze_determinism
from pyconsensus_tpu_torch.analysis.cli import run as cli_run
from pyconsensus_tpu_torch.analysis.determinism import (
    DETERMINISM_RULES, STATIC_DETERMINISM_RULES, analyze_determinism,
    cuda_float_atomics)
from pyconsensus_tpu_torch.analysis.determinism_witness import (
    DeterminismWitnessViolation, DigestWitness, _canonical_record_digest,
    digest_witnessed)

REPO = pathlib.Path(__file__).resolve().parents[1]
CSRC = REPO / "pyconsensus_tpu_torch" / "csrc"


@pytest.fixture(autouse=True)
def float64():
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(prev)


def _write(tmp_path, files):
    for name, src in files.items():
        (tmp_path / f"{name}.py").write_text(textwrap.dedent(src))


def _det(tmp_path, **files):
    """Write ``name -> source`` modules and run Layer 6 over the dir."""
    _write(tmp_path, files)
    return analyze_determinism(paths=[tmp_path])


def _rules(findings):
    return sorted({f.rule for f in findings})


# ------------------------------------------------------------ the corpus

ROUND_DIGEST = """
    import hashlib

    def round_digest(votes):
        h = hashlib.sha256()
        for name, vote in votes.items():
            h.update(f"{name}={vote}".encode())
        return h.hexdigest()
    """

#: case name -> {module name: source}
CASES = {
    "dict_fold_into_digest": {"m": ROUND_DIGEST},
    "sorted_dict_fold": {"m": """
        import hashlib

        def round_digest(votes):
            h = hashlib.sha256()
            for name, vote in sorted(votes.items()):
                h.update(f"{name}={vote}".encode())
            return h.hexdigest()
        """},
    "glob_into_journal": {"bad": """
        def ship(log, root):
            for p in root.glob("*.npz"):
                log.journal_block(p.read_bytes())
        """, "ok": """
        def ship(log, root):
            for p in sorted(root.glob("*.npz")):
                log.journal_block(p.read_bytes())
        """},
    "set_iteration_into_digest": {"m": """
        import hashlib

        def digest(names):
            h = hashlib.sha256()
            for n in {x.strip() for x in names}:
                h.update(n.encode())
            return h.hexdigest()
        """},
    "json_without_sort_keys": {"bad": """
        import json

        def artifact(stats):
            rows = [v for v in stats.values()]
            return json.dumps(rows)
        """, "ok": """
        import json

        def artifact(stats):
            rows = [v for v in stats.values()]
            return json.dumps(rows, sort_keys=True)
        """},
    "interprocedural_category": {"m": """
        import hashlib

        def collect(stats):
            out = []
            for k, v in stats.items():
                out.append(f"{k}={v}")
            return out

        def digest(stats):
            h = hashlib.sha256()
            for row in collect(stats):
                h.update(row.encode())
            return h.hexdigest()
        """},
    "pragma_with_rationale": {"m": """
        import hashlib

        def round_digest(votes):
            h = hashlib.sha256()
            for name, vote in votes.items():
                # fixed field set; order never reaches the bytes
                h.update(name.encode())  # consensus-lint: disable=CL1001
            return h.hexdigest()
        """},
    "as_completed_into_digest": {"m": """
        import hashlib
        from concurrent.futures import as_completed

        def digest(futures):
            h = hashlib.sha256()
            for fut in as_completed(futures):
                h.update(fut.result())
            return h.hexdigest()
        """},
    "sequence_keyed_fold": {"m": """
        import hashlib
        from concurrent.futures import as_completed

        def digest(futures):
            pairs = []
            for fut in as_completed(futures):
                pairs.append((futures[fut], fut.result()))
            h = hashlib.sha256()
            for key, payload in sorted(pairs):
                h.update(payload)
            return h.hexdigest()
        """},
    "wallclock_into_journal": {"m": """
        import time

        def stamp(log, block):
            log.journal_block({"t": time.time(), "block": block})
        """},
    "id_into_digest": {"m": """
        import hashlib

        def digest(obj):
            return hashlib.sha256(str(id(obj)).encode()).hexdigest()
        """},
    "seeded_and_unseeded_rng": {"bad": """
        import numpy as np

        def record(ledger, result):
            rng = np.random.default_rng()
            ledger.record_round({"jitter": rng.random(), **result})
        """, "ok": """
        import numpy as np

        def record(ledger, result, seed):
            rng = np.random.default_rng(seed)
            ledger.record_round({"jitter": rng.random(), **result})
        """},
    "augassign_fold_over_values": {"m": """
        def record(ledger, stakes, result):
            total = 0.0
            for s in stakes.values():
                total += s
            ledger.record_round({"total": total, **result})
        """},
    "sum_over_unordered": {"bad": """
        def record(ledger, stakes, result):
            total = sum(stakes.values())
            ledger.record_round({"total": total, **result})
        """, "ok": """
        def record(ledger, stakes, result):
            total = sum(sorted(stakes.values()))
            ledger.record_round({"total": total, **result})
        """},
}


# ------------------------------------------------------------- CL1001


class TestUnorderedIteration:
    def test_dict_fold_into_digest_triggers(self, tmp_path):
        """A digest folded over dict iteration order. The finding names
        the sink AND the unordered source."""
        fs = _det(tmp_path, **CASES["dict_fold_into_digest"])
        assert _rules(fs) == ["CL1001"]
        (f,) = fs
        assert "digest" in f.message and ".items()" in f.message

    def test_sorted_dict_fold_is_clean(self, tmp_path):
        assert _det(tmp_path, **CASES["sorted_dict_fold"]) == []

    def test_glob_into_journal_triggers_sorted_is_clean(self, tmp_path):
        fs = _det(tmp_path, **CASES["glob_into_journal"])
        assert _rules(fs) == ["CL1001"]
        assert all(f.path.endswith("bad.py") for f in fs)

    def test_set_iteration_into_digest_triggers(self, tmp_path):
        fs = _det(tmp_path, **CASES["set_iteration_into_digest"])
        assert _rules(fs) == ["CL1001"]

    def test_json_without_sort_keys_triggers_canonical_is_clean(
            self, tmp_path):
        fs = _det(tmp_path, **CASES["json_without_sort_keys"])
        assert _rules(fs) == ["CL1001"]
        assert all(f.path.endswith("bad.py") for f in fs)
        assert "sort_keys" in fs[0].message

    def test_interprocedural_category_threads_through_helper(
            self, tmp_path):
        """The helper RETURNS the unordered value; the caller digests
        it. The category must survive the summary round trip."""
        fs = _det(tmp_path, **CASES["interprocedural_category"])
        assert any(f.rule == "CL1001" and "digest" in f.message
                   for f in fs)

    def test_pragma_with_rationale_suppresses(self, tmp_path):
        assert _det(tmp_path, **CASES["pragma_with_rationale"]) == []


# ------------------------------------------------------------- CL1002


class TestCompletionOrder:
    def test_as_completed_fold_into_digest_triggers(self, tmp_path):
        fs = _det(tmp_path, **CASES["as_completed_into_digest"])
        assert _rules(fs) == ["CL1002"]
        assert "as_completed" in fs[0].message

    def test_sequence_keyed_fold_is_clean(self, tmp_path):
        assert _det(tmp_path, **CASES["sequence_keyed_fold"]) == []


# ------------------------------------------------------------- CL1003


class TestHostNondeterminism:
    def test_wallclock_into_journal_triggers(self, tmp_path):
        fs = _det(tmp_path, **CASES["wallclock_into_journal"])
        assert _rules(fs) == ["CL1003"]
        assert "time.time()" in fs[0].message

    def test_id_into_digest_triggers(self, tmp_path):
        fs = _det(tmp_path, **CASES["id_into_digest"])
        assert _rules(fs) == ["CL1003"]

    def test_seeded_rng_is_clean_unseeded_triggers(self, tmp_path):
        fs = _det(tmp_path, **CASES["seeded_and_unseeded_rng"])
        assert _rules(fs) == ["CL1003"]
        assert all(f.path.endswith("bad.py") for f in fs)


# ------------------------------------------------------------- CL1004


class TestFloatAccumulation:
    def test_augassign_fold_over_values_triggers(self, tmp_path):
        fs = _det(tmp_path, **CASES["augassign_fold_over_values"])
        assert _rules(fs) == ["CL1004"]
        assert "+=" in fs[0].message

    def test_sum_over_unordered_triggers_sorted_is_clean(self, tmp_path):
        fs = _det(tmp_path, **CASES["sum_over_unordered"])
        assert _rules(fs) == ["CL1004"]
        assert all(f.path.endswith("bad.py") for f in fs)


# ----------------------------------------------------- parity with jax


@pytest.mark.parametrize("case", sorted(CASES))
def test_parity_with_the_reference(case, tmp_path):
    """The port's Layer 6 taint pass and the reference's report the same
    (rule, file, line) set on every planted snippet."""
    _write(tmp_path, CASES[case])
    keep = STATIC_DETERMINISM_RULES
    ours = {(f.rule, f.path, f.line)
            for f in analyze_determinism(paths=[tmp_path])
            if f.rule in keep}
    theirs = {(f.rule, f.path, f.line)
              for f in ref_analyze_determinism(paths=[tmp_path])
              if f.rule in keep}
    assert ours == theirs


# ------------------------------------------------ CL1005: float atomics

CUDA_CORPUS = r"""
#include <atomic>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

__global__ void fold(float* out, const float* __restrict__ x, int* cnt,
                     double* acc, __half* h, unsigned long long* ticks) {
  __shared__ float s_sum[32];
  atomicAdd(&out[threadIdx.x], x[0]);
  atomicAdd(cnt, 1);
  atomicAdd_block(&s_sum[0], 1.0f);
  atomicAdd(ticks, 1ULL);
  atomicAdd_system(acc + 3, 2.0);
  atomicAdd(h, __float2half(1.0f));
  atomicAdd((float*)cnt, 0.5f);
  atomicAdd(&out[1], x[1]);  // consensus-lint: disable=CL1005 — corpus
  // atomicAdd(&out[2], 1.0f);
  /* atomicAdd(&out[3], 1.0f); */
}

static std::atomic<int> last_smem[8];
static std::atomic<unsigned long long> opted{0};

void host_counters() {
  last_smem[0].fetch_add(1);
  opted += 1;
}
"""


class TestFloatAtomics:
    def test_float_atomic_add_fires_in_cuda_corpus(self, tmp_path):
        """Float, double and half operands fire (by declaration or a
        cast); integer atomics, commented-out calls and the host-side
        std::atomic counters stay silent; a directive suppresses."""
        (tmp_path / "k.cu").write_text(CUDA_CORPUS)
        fs = analyze_determinism(paths=[tmp_path], select={"CL1005"})
        assert _rules(fs) == ["CL1005"]
        assert [f.line for f in fs] == [9, 11, 13, 14, 15]
        assert all(f.path == "k.cu" for f in fs)
        assert "'atomicAdd_block' on a float operand" in fs[1].message
        assert "double" in fs[2].message and "__half" in fs[3].message

    def test_std_atomic_int_is_silent(self):
        src = ("static std::atomic<int> last_smem[4];\n"
               "void f() { last_smem[0].fetch_add(1); }\n"
               "__global__ void g(int* c) { atomicAdd(c, 1); }\n")
        assert cuda_float_atomics(src, "s.cu") == []

    def test_cuh_headers_are_scanned(self, tmp_path):
        (tmp_path / "h.cuh").write_text(
            "__device__ void acc(double* d, double v) {\n"
            "  atomicAdd(d, v);\n}\n")
        fs = analyze_determinism(paths=[tmp_path], select={"CL1005"})
        assert [(f.path, f.line) for f in fs] == [("h.cuh", 2)]

    def test_accumulating_torch_scatters_fire(self, tmp_path):
        fs = _det(tmp_path, m="""
            import numpy as np
            import torch

            def fold(out, idx, src, w):
                out.index_add_(0, idx, src)
                out.scatter_add_(0, idx, src)
                out.scatter_reduce_(0, idx, src, reduce="sum")
                out.index_put_((idx,), src, accumulate=True)
                torch.bincount(idx, weights=w)
                return torch.index_add(out, 0, idx, src)

            def exact(out, idx, src):
                out.index_put_((idx,), src)
                out.index_put_((idx,), src, accumulate=False)
                np.bincount(idx.numpy(), weights=src.numpy())
                return torch.bincount(idx)
            """)
        assert _rules(fs) == ["CL1005"]
        assert [f.line for f in fs] == [6, 7, 8, 9, 10, 11]
        assert "index_add_" in fs[0].message

    def test_python_directive_suppresses(self, tmp_path):
        fs = _det(tmp_path, m="""
            def fold(out, idx, src):
                out.index_add_(0, idx, src)  # consensus-lint: disable=CL1005 — corpus
            """)
        assert fs == []

    def test_shipped_kernels_are_clean(self):
        """The ground rule holds on the port's CUDA sources today; the
        host-side std::atomic counters (resolve.cu, storage_sweeps.cu)
        are the only atomics there."""
        sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
        assert len(sources) >= 3
        text = {p.name: p.read_text(encoding="utf-8") for p in sources}
        assert "std::atomic<int>" in text["resolve.cu"]
        assert "std::atomic<unsigned long long>" in text["storage_sweeps.cu"]
        for name, src in text.items():
            assert cuda_float_atomics(src, name) == [], name

    def test_no_determinism_skips_cl1005(self, tmp_path):
        (tmp_path / "k.cu").write_text(CUDA_CORPUS)
        buf = io.StringIO()
        assert cli_run(["--no-baseline", str(tmp_path)], stdout=buf) == 1
        assert "CL1005" in buf.getvalue()
        assert cli_run(["--no-baseline", "--no-determinism",
                        str(tmp_path)], stdout=io.StringIO()) == 0


# ------------------------------------------------- registry + package


class TestLayerSurface:
    def test_rules_registered(self):
        assert set(DETERMINISM_RULES) == {"CL1001", "CL1002", "CL1003",
                                          "CL1004", "CL1005"}
        assert all(sev == "error"
                   for sev, _ in DETERMINISM_RULES.values())
        assert STATIC_DETERMINISM_RULES == \
            frozenset({"CL1001", "CL1002", "CL1003", "CL1004"})

    def test_package_is_clean(self):
        """The shipped baseline stays EMPTY: Layer 6 over the port (the
        Python and the CUDA sources)."""
        fs = analyze_determinism()
        assert fs == [], [f.render() for f in fs]


# ------------------------------------------------------------ witness


class TestDigestWitness:
    def _session(self, root, name="dw", n=6):
        from pyconsensus_tpu_torch.serve.failover import DurableSession

        return DurableSession.create(root, name, n, device="cpu")

    def _run_rounds(self, root, rounds=2):
        rng = np.random.default_rng(0)
        s = self._session(root)
        for _ in range(rounds):
            s.append(rng.choice([0.0, 1.0], size=(6, 4)))
            s.append(rng.choice([0.0, 1.0], size=(6, 4)))
            s.resolve()
        return s

    def test_green_over_real_session_ops(self, tmp_path):
        """Real journal/commit/record traffic: every digest replays
        bit-identical from the durable artifacts at check()."""
        with digest_witnessed(dump_path=tmp_path / "dw.json") as w:
            self._run_rounds(tmp_path / "log")
        rep = w.check()
        ops = {r["op"] for r in rep["records"]}
        assert {"journal_block", "commit_round", "record_round"} <= ops
        assert rep["checked"] >= 3 and rep["recorded"] >= 6

    def test_tampered_commit_digest_is_flagged(self, tmp_path):
        w = DigestWitness().install()
        try:
            self._run_rounds(tmp_path / "log")
        finally:
            w.uninstall()
        victim = next(r for r in reversed(w.records)
                      if r["op"] == "commit_round")
        real = victim["digests"][0]
        victim["digests"][0] = "0" * 64
        with pytest.raises(DeterminismWitnessViolation) as ei:
            w.check(dump_path=tmp_path / "viol.json")
        assert ei.value.op.startswith("commit_round[")
        assert ei.value.recorded == "0" * 64
        assert ei.value.replayed == real
        assert pathlib.Path(ei.value.dump_path).exists()

    def test_tampered_journal_digest_is_flagged(self, tmp_path):
        w = DigestWitness().install()
        try:
            rng = np.random.default_rng(1)
            s = self._session(tmp_path / "log")
            s.append(rng.choice([0.0, 1.0], size=(6, 4)))
        finally:
            w.uninstall()
        victim = next(r for r in w.records if r["op"] == "journal_block")
        victim["digest"] = "f" * 64
        with pytest.raises(DeterminismWitnessViolation) as ei:
            w.check(dump_path=tmp_path / "viol.json")
        assert ei.value.op.startswith("journal_block[")
        assert ei.value.recorded == "f" * 64

    def test_reordered_fold_mock_is_flagged_at_the_call_site(self):
        import hashlib

        def broken(final_reps):
            h = hashlib.sha256()
            for k, v in final_reps.items():   # the reordered fold
                h.update(f"{k}={v}".encode())
            return h.hexdigest()

        w = DigestWitness()
        wrapped = w._wrap_mechanism_digest(broken)
        with pytest.raises(DeterminismWitnessViolation) as ei:
            wrapped({"a": 1.0, "b": 2.0})
        assert ei.value.op == "mechanism_digest"
        assert ei.value.recorded != ei.value.replayed
        assert len(ei.value.recorded) == 64

    def test_real_mechanism_digest_is_order_invariant(self):
        from pyconsensus_tpu_torch.econ import scoreboard

        with digest_witnessed() as w:
            d = scoreboard.mechanism_digest(
                {"m1": np.float64(0.25), "m0": np.float64(0.75)})
        assert len(d) == 64
        assert any(r["op"] == "mechanism_digest" for r in w.records)

    def test_torn_down_artifacts_are_skipped_not_flagged(self, tmp_path):
        w = DigestWitness().install()
        try:
            self._run_rounds(tmp_path / "log")
        finally:
            w.uninstall()
        shutil.rmtree(tmp_path / "log")
        rep = w.check()
        assert rep["checked"] == 0 and rep["skipped"] >= 3

    def test_uninstall_restores_surfaces(self):
        from pyconsensus_tpu_torch.econ import scoreboard
        from pyconsensus_tpu_torch.serve.failover import ReplicationLog

        real_j = ReplicationLog.journal_block
        real_m = scoreboard.mechanism_digest
        w = DigestWitness().install()
        assert ReplicationLog.journal_block is not real_j
        assert scoreboard.mechanism_digest is not real_m
        w.uninstall()
        assert ReplicationLog.journal_block is real_j
        assert scoreboard.mechanism_digest is real_m

    def test_canonical_record_digest_is_key_order_free(self):
        a = {"round": 1, "certainty": 0.5}
        b = {"certainty": 0.5, "round": 1}
        assert _canonical_record_digest(a) == _canonical_record_digest(b)


# -------------------------------------- shuffled-directory replay


class TestShuffledDirectoryReplay:
    def test_replay_is_bit_identical_under_shuffled_readdir(
            self, tmp_path):
        """Clone a live log by copying its files in a SHUFFLED creation
        order (perturbing readdir order) — takeover replay and resolve
        must produce bit-identical outcomes and reputation."""
        from pyconsensus_tpu_torch.serve.failover import (DurableSession,
                                                          replay_session)

        rng = np.random.default_rng(7)
        src = DurableSession.create(tmp_path / "a", "shuf", 6,
                                    device="cpu")
        src.append(rng.choice([0.0, 1.0], size=(6, 4)))
        src.append(rng.choice([0.0, 1.0], size=(6, 4)))
        src.resolve()
        src.append(rng.choice([0.0, 1.0], size=(6, 4)))

        files = sorted((tmp_path / "a" / "shuf").rglob("*"))
        order = np.random.default_rng(11).permutation(len(files))
        for i in order:
            f = files[int(i)]
            dst = tmp_path / "b" / "shuf" / f.relative_to(
                tmp_path / "a" / "shuf")
            dst.parent.mkdir(parents=True, exist_ok=True)
            if f.is_file():
                dst.write_bytes(f.read_bytes())

        twin = replay_session(tmp_path / "b", "shuf", device="cpu")
        block = rng.choice([0.0, 1.0], size=(6, 4))
        src.append(block.copy())
        twin.append(block.copy())
        got, want = twin.resolve(), src.resolve()
        np.testing.assert_array_equal(
            np.asarray(got["outcomes_adjusted"]),
            np.asarray(want["outcomes_adjusted"]))
        np.testing.assert_array_equal(
            np.asarray(got["smooth_rep"]),
            np.asarray(want["smooth_rep"]))


# --------------------------------------------------- --format sarif


class TestSarifOutput:
    def _run(self, args):
        buf = io.StringIO()
        code = cli_run(args, stdout=buf)
        return code, buf.getvalue()

    def test_schema_and_exit_code(self, tmp_path):
        target = tmp_path / "m.py"
        target.write_text(textwrap.dedent(ROUND_DIGEST))
        code, out = self._run(["--format", "sarif", "--no-baseline",
                               "--select", "CL1001", str(target)])
        assert code == 1
        doc = json.loads(out)
        assert doc["version"] == "2.1.0"
        assert "sarif" in doc["$schema"]
        run = doc["runs"][0]
        driver = run["tool"]["driver"]
        assert driver["name"] == "consensus-lint"
        rule_ids = [r["id"] for r in driver["rules"]]
        assert rule_ids == ["CL1001"]
        (res,) = run["results"]
        assert res["ruleId"] == "CL1001"
        assert rule_ids[res["ruleIndex"]] == "CL1001"
        assert res["level"] == "error"
        assert res["baselineState"] == "new"
        assert "consensusLint/v1" in res["partialFingerprints"]
        loc = res["locations"][0]["physicalLocation"]
        assert loc["artifactLocation"]["uri"].endswith("m.py")
        assert loc["region"]["startLine"] >= 1
        assert "unordered-iteration" in res["message"]["text"]

    def test_baselined_state_and_exit_zero(self, tmp_path):
        target = tmp_path / "m.py"
        target.write_text(textwrap.dedent(ROUND_DIGEST))
        baseline = tmp_path / "baseline.json"
        code, _ = self._run(["--update-baseline", "--baseline",
                             str(baseline), "--select", "CL1001",
                             str(target)])
        assert code == 0
        code, out = self._run(["--format", "sarif", "--baseline",
                               str(baseline), "--select", "CL1001",
                               str(target)])
        assert code == 0
        (res,) = json.loads(out)["runs"][0]["results"]
        assert res["baselineState"] == "unchanged"

    def test_clean_tree_empty_results(self, tmp_path):
        target = tmp_path / "m.py"
        target.write_text("def ok():\n    return 1\n")
        code, out = self._run(["--format", "sarif", "--no-baseline",
                               str(target)])
        assert code == 0
        run = json.loads(out)["runs"][0]
        assert run["results"] == [] and run["tool"]["driver"]["rules"] == []

    def test_no_determinism_excludes_layer6(self, tmp_path):
        target = tmp_path / "m.py"
        target.write_text(textwrap.dedent(ROUND_DIGEST))
        code, out = self._run(["--format", "json", "--no-baseline",
                               "--no-determinism", str(target)])
        assert code == 0
        assert json.loads(out)["findings"] == []
