#!/usr/bin/env python3
"""Where the column-tile pass's time goes: variants of
``pyconsensus_tpu_torch/csrc/storage_sweeps.cu`` that each drop or change
one part of ``col_tile_kernel``, timed on one card against the kernel as
it is.

    python3 tools/col_tile_lab.py                  # every variant
    python3 tools/col_tile_lab.py base copy_only
    python3 tools/col_tile_lab.py --parent .proof/parent base parent

Variants (each a text edit of the source, asserted to apply):

- ``base``: the source as it is;
- ``copy_only``: the chunks are copied, nothing is summed;
- ``compute_only``: only the first two chunks are copied, every chunk is
  summed (from whatever the stages hold);
- ``checked_stage``: every chunk staged through the checked copies of
  ``stage_x_tile`` and ``stage_rows``, none through the unchecked ones;
- ``unroll2``: the loop over a chunk's rows unrolled twice;
- ``one_block``: one block per SM (launch bounds and the split rule)
  instead of two;
- ``i2f``: the int8 decode through an int-to-float conversion instead of
  the byte-into-mantissa trick;
- ``parent``: the ``storage_sweeps.cu`` of another checkout (``--parent``,
  the root of a tree whose ``pyc_col_pass`` takes a chunk count and a
  mean: the column pass before the column-tile kernel), its launches of
  at most 8 rows grouped as its wrapper grouped them.

Each variant is built with ``nvcc`` into the ignored build directory, all
at once, and its ``pyc_col_pass`` is launched directly (the split count
of ``ck.col_tile_splits``) on the 10,000 x 100,000 matrix of
``chip_smoke.py``: int8 with a fill vector at k = 1 and 5 centered (the
covariance sweeps) and k = 3, 6, 8, 12 and 16 uncentered, int8 k = 12
without a fill, and float32+NaN at k = 6 and 12. Medians of 10 CUDA-event
timings, two rounds, each beside its bound (one read of X and the
vectors at 3.35 TB/s, or 2kRE float32 operations at 67 TFLOP/s), and,
for the variants that sum, the largest error on the first and last 1024
columns against a float64 product over max(max |ref|, 1). Compare
variants only within one call.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "pyconsensus_tpu_torch", "csrc")
OUT = os.path.join(CSRC, "build", "col_lab")
R, E = 10_000, 100_000
NAMES = ("base", "copy_only", "compute_only", "checked_stage", "unroll2",
         "one_block", "i2f")
#: rows of one launch of the parent's column pass, and its chunk count
PARENT_K, PARENT_CHUNKS = 8, 64

_SKIP_SUMS = "    if (!live) continue;"
_CHUNK_COPY = "    if (i + kStages - 1 < n) stage(i + kStages - 1);"
_BLOCKS = "constexpr int kColTileBlocksPerSm = 2;"
_FAST = "    if (fast && r0 + kTileRows <= R) {"
_ROWS = "#pragma unroll 1\n    for (int r = 0; r < RPG; r += 4) {"
_BYTE_TRICK = """    val[j] = fmaf(__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440u + j)),
                  0.5f, -4194368.f);"""


def _edit(text: str, old: str, new: str) -> str:
    if old not in text:
        raise RuntimeError(f"the source no longer holds {old!r}")
    return text.replace(old, new)


def variants(src: str) -> dict:
    return {
        "base": src,
        "copy_only": _edit(src, _SKIP_SUMS, "    continue;"),
        "compute_only": _edit(src, _CHUNK_COPY,
                              _CHUNK_COPY.replace("if (i + kStages - 1 < n)",
                                                  "if (false)")),
        "checked_stage": _edit(src, _FAST, "    if (false) {"),
        "unroll2": _edit(src, _ROWS, _ROWS.replace("unroll 1", "unroll 2")),
        "one_block": _edit(src, _BLOCKS, _BLOCKS.replace("2;", "1;")),
        "i2f": _edit(src, _BYTE_TRICK, "    val[j] = static_cast<float>("
                     "static_cast<int8_t>((w >> (8 * j)) ^ 0x80u)) * 0.5f;"),
    }


def build(names, parent) -> dict:
    from pyconsensus_tpu_torch.ops.build import (ARCH_FLAGS, NVCC_FLAGS,
                                                 nvcc_path)

    table = variants(open(os.path.join(CSRC, "storage_sweeps.cu")).read())
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name in names:
        if name == "parent":
            pcsrc = os.path.join(os.path.abspath(parent),
                                 "pyconsensus_tpu_torch", "csrc")
            cu, inc = os.path.join(pcsrc, "storage_sweeps.cu"), pcsrc
        else:
            cu, inc = os.path.join(OUT, f"{name}.cu"), CSRC
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
    """One line per column-pass instantiation of an ``-Xptxas -v``
    report: its template arguments, registers and spill bytes."""
    rows, entry, spill = [], None, ""
    for ln in text.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else ln
            entry = name if ("col_tile_kernel" in name
                             or "col_partial_kernel" in name) else None
        elif entry and "spill stores" in ln:
            spill = ln.strip()
        elif entry and "Used" in ln and "registers" in ln:
            args = entry.split("kernelI", 1)[-1].split("EEv", 1)[0]
            regs = ln.split("Used", 1)[1].split("registers")[0].strip()
            rows.append(f"{args}: {regs} registers; {spill}")
            entry = None
    return rows


def launcher(torch, name, path, x, k, m, a, W, n_sm):
    """A function that runs the variant's column pass once on ``x``."""
    from pyconsensus_tpu_torch.ops import cuda_kernels as ck

    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib = ctypes.CDLL(path)
    run = lib.pyc_col_pass
    run.restype = I
    dev = x.device
    stream = torch.cuda.current_stream().cuda_stream
    is8 = int(x.dtype == torch.int8)
    out = torch.empty((k, E), device=dev)
    if name == "parent":
        # the parent's pass: a mean always (zeros when uncentered), at
        # most 8 rows and 64 row chunks a launch
        run.argtypes = [P, I, LL, LL, P, P, P, I, LL, P, P, P]
        mean = m if m is not None else torch.zeros(E, device=dev)
        groups = [(c, min(c + PARENT_K, k)) for c in range(0, k, PARENT_K)]
        parts = {g: torch.empty((PARENT_CHUNKS, g[1] - g[0], E), device=dev)
                 for g in groups}
        ws = {g: W[g[0]:g[1]].contiguous() for g in groups}
        calls = [(x.data_ptr(), is8, R, E, mean.data_ptr(),
                  None if a is None else a.data_ptr(), ws[g].data_ptr(),
                  g[1] - g[0], PARENT_CHUNKS, parts[g].data_ptr(),
                  out[g[0]:g[1]].data_ptr(), stream) for g in groups]
    else:
        run.argtypes = [P, I, LL, LL, P, P, P, I, I, P, P, P]
        S = ck.col_tile_splits(R, E, x.element_size(), n_sm)
        part = torch.empty((S, k, E), device=dev)
        calls = [(x.data_ptr(), is8, R, E,
                  None if m is None else m.data_ptr(),
                  None if a is None else a.data_ptr(), W.data_ptr(), k, S,
                  part.data_ptr(), out.data_ptr(), stream)]

    def once():
        for args in calls:
            if run(*args) != 0:
                raise RuntimeError(f"{name}: launch failed")
        return out

    return once


def main(argv=None) -> int:
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("names", nargs="*", default=list(NAMES))
    ap.add_argument("--parent", default=None,
                    help="root of a checkout whose column pass is timed as "
                    "the 'parent' variant")
    args = ap.parse_args(argv)
    names = list(args.names)
    if args.parent and "parent" not in names:
        names.append("parent")
    if "parent" in names and not args.parent:
        ap.error("the parent variant needs --parent")
    if not torch.cuda.is_available():
        print("col_tile_lab: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    libs = build(names, args.parent)
    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    x8, _ = cs.gen_reports(torch, R, E, 0, dev)
    xf = torch.where(x8 < 0, torch.full((), float("nan"), device=dev),
                     x8.float() * 0.5)
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    fill = torch.rand(E, generator=g, device=dev)
    mu = torch.rand(E, generator=g, device=dev)
    a = (fill - mu).contiguous()
    Ws = {k: torch.randn((k, R), generator=g, device=dev)
          for k in (1, 3, 5, 6, 8, 12, 16)}
    cases = [(f"int8 k={k}{' centered' if c else ''}", x8, k, c, True)
             for k, c in ((1, True), (5, True), (3, False), (6, False),
                          (8, False), (12, False), (16, False))]
    cases += [("int8 k=12 no fill", x8, 12, False, False),
              ("float32 k=6", xf, 6, False, True),
              ("float32 k=12", xf, 12, False, True)]
    times, errs, refs = {}, {}, {}
    cols = torch.cat([torch.arange(1024), torch.arange(E - 1024, E)]).to(dev)
    for _ in range(2):
        for name, path in libs.items():
            for case, x, k, centered, with_fill in cases:
                m = mu if centered else None
                av = (a if centered else fill) if with_fill else None
                once = launcher(torch, name, path, x, k, m, av, Ws[k], n_sm)
                got = once().clone()
                torch.cuda.synchronize()
                if case not in refs:
                    xs = x[:, cols]
                    val = (xs.double() * 0.5 if x.dtype == torch.int8
                           else xs.double())
                    absent = xs < 0 if x.dtype == torch.int8 else xs.isnan()
                    xc = val - m[cols].double() if m is not None else val
                    if av is not None:
                        xc = torch.where(absent, av[cols].double()[None, :],
                                         xc)
                    refs[case] = Ws[k].double() @ xc
                if name not in ("copy_only", "compute_only"):
                    ref = refs[case]
                    errs[name, case] = float(
                        (got[:, cols].double() - ref).abs().max()) / max(
                            float(ref.abs().max()), 1.0)
                times.setdefault((name, case), []).append(
                    cs.time_ms(torch, once, 10))
    for (name, case), ms in times.items():
        x = xf if case.startswith("float32") else x8
        k = int(case.split("k=")[1].split()[0])
        b_ms, b_by = cs.bound_ms(x.numel() * x.element_size()
                                 + 4 * (k * R + 2 * E) + 4 * k * E,
                                 2 * k * R * E)
        err = errs.get((name, case))
        print(f"{name:13s} {case:20s} " + " ".join(f"{t:.4f}" for t in ms)
              + f" ms (bound {b_ms:.4f} {b_by}"
              + (f", err {err:.1e}" if err is not None else "")
              + f") on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
