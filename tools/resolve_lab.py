#!/usr/bin/env python3
"""Where the resolve kernel's time goes: the column-panel kernel of
``pyconsensus_tpu_torch/csrc/resolve.cu`` and variants of it, the row
half (the row-tile pass at k = 2 with the absent op), and, with
``--parent``, another checkout's resolve kernel and variants of its column
kernel, all timed on one card in one call.

    python3 tools/resolve_lab.py
    python3 tools/resolve_lab.py --parent .proof/parent

Variants of this tree's ``resolve.cu`` (each a text edit, asserted to
apply), launched through ``pyc_resolve_cols``:

- ``base``: the source as it is, and with one block a panel (``base
  one_panel``: no persistent grid, so no panel follows another in a
  block);
- ``no_prefetch``: no cross-panel prefetch: a panel's copies go out only
  once the panel before it is done;
- ``copy_only``: the chunks are copied and waited for, nothing is walked;
- ``walks_only``: nothing is copied, both walks run (on whatever the ring
  holds); ``walks_norep``: the same with a constant for the reputation,
  so that its loads drop out;
- ``spare1``: one ring slot beyond the panel's chunks (the source has
  none), so the next panel's first chunk lands before walk 2 starts but
  the SM keeps 28 KB of L1, not 60;
- ``rows2``: two rows a thread a chunk (the source takes four);
- ``ahead128k``: 128 KB of copies in flight ahead of walk 1 (the source
  keeps 64 KB);
- ``l2_256``: the copies ask L2 to fetch 256 bytes around each 16
  (``cp.async ... .L2::256B``), so that neighbouring panels' blocks find
  their rows there.

``rows`` is the row half alone: ``pyc_row_tile_absent`` of the package's
``storage_sweeps.cu`` at k = 2 over ``[cert; 1]``; ``wrapper`` is
``resolve_certainty_fused`` itself, both halves around the call.

With ``--parent <tree>`` (a checkout whose ``resolve.cu`` still holds
``pyc_resolve_certainty``: the resident-panel column kernel and the
8-row-block row pass), variants of that source:

- ``parent``: both halves as they were;
- ``parent_cols``: the column kernel alone; ``parent_rows``: the row
  kernel alone (over the reference certainty);
- ``parent_staging``: the column kernel's staging alone; ``parent_walk1``
  and ``parent_walk2``: one walk alone, with no staging;
- ``parent_half``: the column kernel at half-width panels (8 bytes a row:
  C = 8 int8, 2 float32) and two blocks an SM, so that one block's
  staging overlaps the other's walks.

Cases: int8 sentinel storage and float32+NaN at 10,000 x 100,000 (the
matrix of ``chip_smoke.py``). Medians of 10 CUDA-event timings, two
rounds; each launch that computes is held against the plain version,
taken on the card before any launch and kept on the host: the largest
error over max(max |ref|, 1), and whether the snapped outcomes and absent
counts are equal. ``-Xptxas -v`` registers and spills of every resolve
kernel come first. Compare variants only within one call.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "pyconsensus_tpu_torch", "csrc")
OUT = os.path.join(CSRC, "build", "resolve_lab")
R, E = 10_000, 100_000
TOL = 0.1
NAMES = ("base", "no_prefetch", "copy_only", "walks_only", "walks_norep",
         "spare1", "rows2", "ahead128k", "l2_256")
PARENT_NAMES = ("parent", "parent_cols", "parent_rows", "parent_staging",
                "parent_walk1", "parent_walk2", "parent_half")

# this tree's column kernel
_WALK1 = "        walk1<T, CW>(*reinterpret_cast"
_WALK2 = "        if constexpr (BYTES)\n          walk2_bytes"
_COPY = "      copy_granule<T, CW>("
_AHEAD = "constexpr int kAheadBytes = 65536;"
_CAP = "    const long long cap = total;"
_CP16 = "cp.async.cg.shared.global [%0], [%1], 16;"
_CPN = "cp.async.ca.shared.global [%0], [%1], %2;"
_REP = "rs[u] = r < R ? __ldg(rep + r) : 0.f;"
_SPARE = "constexpr int kSpareSlots = 0;"
_ROWS = "constexpr int kMinChunkRows = 4;"
# the parent's kernels
_P_ROWS = ("  constexpr int VW = 16 / sizeof(T);\n"
           "  const unsigned nrow =")
_P_COLS = "    err = launch_cols<T, CC>("
_P_STAGED = "  __syncthreads();\n\n  const int cg = tid % NG;"
_P_VEC = "  if (vec16 && col0 + C <= E) {"
_P_SCALAR = "  } else {\n    const long long n = R * C;"
_P_WALK1 = "  for (long long r = g; r < R; r += G) {"
_P_WALK2 = "  // walk 2: reputation mass agreeing with the outcome\n"
_P_BOUNDS = "__launch_bounds__(kResThreads)\nresolve_cols_kernel"
_P_AUX = 4352               # the parent's bytes after the panel


def _edit(text: str, old: str, new: str, count: int = 1) -> str:
    if old not in text:
        raise RuntimeError(f"the source no longer holds {old!r}")
    return text.replace(old, new, count)


def variants(src: str) -> dict:
    table = {
        "base": src,
        "copy_only": _edit(_edit(src, _WALK1, "        if (lo > hi) "
                                 + _WALK1.lstrip()),
                           _WALK2, "        if (lo < hi) {} else "
                           + _WALK2.lstrip()),
        "walks_only": _edit(src, _COPY, "      if (lo > hi) "
                            + _COPY.lstrip()),
    }
    table["no_prefetch"] = _edit(src, _CAP,
                                 "    const long long cap = c0 + npc;")
    table["ahead128k"] = _edit(src, _AHEAD, "constexpr int kAheadBytes = "
                               "131072;")
    table["l2_256"] = _edit(
        _edit(src, _CP16, _CP16.replace("global", "global.L2::256B")),
        _CPN, _CPN.replace("global", "global.L2::256B"))
    table["walks_norep"] = _edit(table["walks_only"], _REP, "rs[u] = 1e-4f;")
    table["spare1"] = _edit(src, _SPARE, "constexpr int kSpareSlots = 1;")
    table["rows2"] = _edit(src, _ROWS, "constexpr int kMinChunkRows = 2;")
    return table


def parent_variants(src: str) -> dict:
    cols = _edit(src, _P_ROWS, "  if (lo < hi) return static_cast<int>("
                 "cudaGetLastError());\n" + _P_ROWS)
    no_stage = _edit(_edit(cols, _P_VEC,
                           "  if (lo > hi && vec16 && col0 + C <= E) {"),
                     _P_SCALAR, "  } else if (lo > hi) {\n"
                     "    const long long n = R * C;")
    return {
        "parent": src,
        "parent_cols": cols,
        "parent_rows": _edit(src, _P_COLS,
                             "    err = lo < hi ? cudaSuccess : "
                             "launch_cols<T, CC>("),
        "parent_staging": _edit(cols, _P_STAGED, "  __syncthreads();\n"
                                "  if (lo < hi) return;\n\n"
                                "  const int cg = tid % NG;"),
        "parent_walk1": _edit(no_stage, _P_WALK2,
                              "  if (lo < hi) return;\n" + _P_WALK2),
        "parent_walk2": _edit(no_stage, _P_WALK1,
                              "  for (long long r = g; r < (lo > hi ? R : "
                              "0); r += G) {"),
        "parent_half": _edit(cols, _P_BOUNDS, "__launch_bounds__(kResThreads,"
                             " 2)\nresolve_cols_kernel"),
    }


def build(names, parent) -> dict:
    from pyconsensus_tpu_torch.ops.build import (ARCH_FLAGS, NVCC_FLAGS,
                                                 nvcc_path)

    table = variants(open(os.path.join(CSRC, "resolve.cu")).read())
    if parent:
        pcsrc = os.path.join(os.path.abspath(parent), "pyconsensus_tpu_torch",
                             "csrc")
        table.update(parent_variants(
            open(os.path.join(pcsrc, "resolve.cu")).read()))
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name in names:
        inc = pcsrc if name.startswith("parent") else CSRC
        cu = os.path.join(OUT, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(table[name])
        lib = os.path.join(OUT, f"lib{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [nvcc_path(), *ARCH_FLAGS, *NVCC_FLAGS, "-I", inc, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{text[-4000:]}")
        print(f"built {name}", flush=True)
        for line in ptxas_summary(text):
            print(f"  {line}", flush=True)
        libs[name] = lib
    return libs


def ptxas_summary(text: str) -> list:
    """One line per resolve kernel instantiation (and row-tile absent
    launch) of an ``-Xptxas -v`` report: its template arguments,
    registers and spill bytes."""
    rows, entry, spill = [], None, ""
    for ln in text.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else ln
            entry = name if ("resolve_" in name or (
                "row_tile_kernel" in name and "Li2ELb1E" in name)) else None
        elif entry and "spill stores" in ln:
            spill = ln.strip()
        elif entry and "Used" in ln and "registers" in ln:
            kern = entry.split("_cu_", 1)[-1]
            regs = ln.split("Used", 1)[1].split("registers")[0].strip()
            rows.append(f"{kern[:60]}: {regs} registers; {spill}")
            entry = None
    return rows


def main(argv=None) -> int:
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from pyconsensus_tpu_torch.models.pipeline import _fill_stats
    from pyconsensus_tpu_torch.ops import build as pkg_build
    from pyconsensus_tpu_torch.ops import cuda_kernels as ck

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("names", nargs="*", default=None)
    ap.add_argument("--parent", default=None,
                    help="root of a checkout whose resolve kernel is timed "
                    "as the parent variants")
    args = ap.parse_args(argv)
    names = list(args.names or (NAMES + (PARENT_NAMES if args.parent
                                         else ())))
    if any(n.startswith("parent") for n in names) and not args.parent:
        ap.error("the parent variants need --parent")
    if not torch.cuda.is_available():
        print("resolve_lab: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    pkg_build.build_all()
    for line in ptxas_summary("\n".join(pkg_build.build_log().values())):
        print(f"  package {line}", flush=True)
    libs = build(names, args.parent)
    storage = pkg_build.load("storage_sweeps.cu")
    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    x8, _ = cs.gen_reports(torch, R, E, 0, dev)
    xf = torch.where(x8 < 0, torch.full((), float("nan"), device=dev),
                     x8.float() * 0.5)
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    rep = torch.rand(R, generator=g, device=dev) + 0.5
    rep = rep / rep.sum()
    _, fill, _, _ = _fill_stats(x8, rep, 0.1, "int8")
    fill = fill.to(torch.float32).contiguous()
    lo, hi = ck._catch_bounds(TOL)
    # [sum(rep), full_total]: the parent reads both from one pointer
    scal = torch.stack([rep.sum(), torch.ones((), device=dev)]).contiguous()
    cases = (("int8", x8), ("float32", xf))
    # the plain version's outputs, taken before any launch, kept on the host
    refs = {case: [o.cpu() for o in ck.resolve_certainty_fused_plain(
        x, rep, fill, 1.0, TOL)] for case, x in cases}
    torch.cuda.synchronize()
    P, I, LL, F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)

    def launcher(name, x, case):
        """``(once, indices of the outputs it computes, bound bytes)``:
        one read of X, of the vectors the half reads and one write of its
        outputs."""
        is8 = int(x.dtype == torch.int8)
        stream = torch.cuda.current_stream().cuda_stream
        outs = [torch.empty(E, device=dev) for _ in range(4)]
        nb = x.numel() * x.element_size()
        cols_bytes = nb + 4 * (R + E) + 4 * 4 * E
        rows_bytes = nb + 4 * 2 * E + 4 * 2 * R
        full_bytes = cols_bytes + 4 * 2 * R
        if name == "wrapper":
            return (lambda: ck.resolve_certainty_fused(x, rep, fill, 1.0,
                                                       TOL),
                    range(6), full_bytes)
        if name == "rows":
            vt = torch.stack([refs[case][2].to(dev),
                              torch.ones(E, device=dev)])
            S = ck.row_tile_splits(R, E, x.element_size(), n_sm)
            t = torch.empty((2, R), device=dev)
            part = torch.empty((S, 2, R), device=dev)

            def rows():
                if storage.pyc_row_tile_absent(
                        x.data_ptr(), is8, R, E, vt.data_ptr(), 2, S,
                        part.data_ptr(), t.data_ptr(), stream) != 0:
                    raise RuntimeError("rows: launch failed")
                return [None] * 4 + [t[0], t[1]]
            return rows, (4, 5), rows_bytes
        lib = ctypes.CDLL(libs[name.split()[0]])
        if name.startswith("parent"):
            run = lib.pyc_resolve_certainty
            run.argtypes = [P, I, LL, LL, I, LL, P, P, P, F, F, P, P, P, P, P,
                            P, P]
            C = ((16 // x.element_size()) // 2 if name == "parent_half"
                 else 16 // x.element_size())
            smem = -(-R * C * x.element_size() // 16) * 16 + _P_AUX
            prow, narow = torch.empty(R, device=dev), torch.empty(R, device=dev)
            outs[2].copy_(refs[case][2].to(dev))    # the rows' certainty
            a = (x.data_ptr(), is8, R, E, C, smem, rep.data_ptr(),
                 fill.data_ptr(), scal.data_ptr(), lo, hi,
                 *[o.data_ptr() for o in outs], prow.data_ptr(),
                 narow.data_ptr(), stream)
            full = outs + [prow, narow]
            idx = {"parent": range(6), "parent_cols": range(4),
                   "parent_half": range(4), "parent_rows": (4, 5)}.get(name,
                                                                       ())
        else:
            run = lib.pyc_resolve_cols
            run.argtypes = [P, I, LL, LL, I, I, P, P, P, P, F, F, P, P, P, P,
                            P]
            a = (x.data_ptr(), is8, R, E,
                 ck.resolve_block_cols(R, x.element_size()),
                 2 ** 30 if "one_panel" in name else n_sm, rep.data_ptr(),
                 fill.data_ptr(), scal.data_ptr(), scal[1:].data_ptr(), lo,
                 hi, *[o.data_ptr() for o in outs], stream)
            full = outs + [None, None]
            idx = (range(4) if name.startswith(("base", "no_prefetch",
                                                 "ahead", "l2_", "spare",
                                                 "rows2"))
                   else ())
        run.restype = I

        def once():
            if run(*a) != 0:
                raise RuntimeError(f"{name}: launch failed")
            return full
        return once, idx, {"parent": full_bytes,
                           "parent_rows": rows_bytes}.get(name, cols_bytes)

    runs = [n for n in names if n != "base"]
    if "base" in names:
        runs = ["base", "base one_panel"] + runs
    runs += ["rows", "wrapper"]
    times, checks, bounds = {}, {}, {}
    for _ in range(2):
        for name in runs:
            for case, x in cases:
                once, idx, nbytes = launcher(name, x, case)
                got = once()
                torch.cuda.synchronize()
                if idx:
                    worst, exact = 0.0, True
                    for i in idx:
                        ref = refs[case][i]
                        d = float((got[i].cpu().double() - ref.double())
                                  .abs().max())
                        worst = max(worst, d / max(float(ref.abs().max()),
                                                   1.0))
                        if i in (1, 5):
                            exact &= bool(torch.equal(got[i].cpu(), ref))
                    checks[name, case] = (worst, exact)
                times.setdefault((name, case), []).append(
                    cs.time_ms(torch, once, 10))
                bounds[name, case] = cs.bound_ms(nbytes, 0)[0]
    table = []
    for (name, case), ms in times.items():
        chk = checks.get((name, case))
        note = ("" if chk is None else
                f", err {chk[0]:.1e}, snapped outcomes and absent counts "
                f"{'equal' if chk[1] else 'DIFFER'}")
        print(f"{name:18s} {case:8s} " + " ".join(f"{t:.4f}" for t in ms)
              + f" ms (bound {bounds[name, case]:.4f} bytes{note}) on {card}",
              flush=True)
        table.append({"variant": name, "case": case, "ms": ms,
                      "bound_ms": bounds[name, case],
                      "err": None if chk is None else chk[0],
                      "exact": None if chk is None else chk[1]})
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "resolve_lab.json"),
              "w") as f:
        json.dump({"card": card, "shape": [R, E], "rows": table}, f,
                  indent=1)
    bad = [k for k, (err, exact) in checks.items()
           if err > cs.FULL_RTOL or not exact]
    if bad:
        print(f"resolve_lab: disagree with the plain version: {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
