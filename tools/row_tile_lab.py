#!/usr/bin/env python3
"""Where the row-tile pass's time goes: variants of
``pyconsensus_tpu_torch/csrc/storage_sweeps.cu`` that each drop one part
of ``row_tile_kernel``, timed on one card against the kernel as it is.

    python3 tools/row_tile_lab.py                  # every variant
    python3 tools/row_tile_lab.py base compute_only
    python3 tools/row_tile_lab.py --parent .proof/parent base parent

Variants (each a text edit of the source, asserted to apply):

- ``base``: the source as it is;
- ``copy_only``: the chunks are copied, nothing is summed;
- ``compute_only``: only the first two chunks are copied, every chunk is
  summed (from whatever the stages hold);
- ``fma_only``: ``compute_only`` with the entries made in registers and
  one V load a slice, so that the FMAs alone remain;
- ``i2f``: the int8 decode through an int-to-float conversion instead of
  the byte-into-mantissa trick;
- ``one_block``: one block an SM and three stages at every k (the k = 1
  launches take two blocks an SM, and the centered int8 one two stages);
- ``parent``: the ``storage_sweeps.cu`` of another checkout (``--parent``,
  the root of a tree that still has ``pyc_row_pass``: the 8-row-block row
  pass before the matvecs took the row-tile pass at k = 1), timed on the
  k = 1 cases only, with a zero mean where uncentered as its wrappers
  passed one.

Each variant is built with ``nvcc`` into the ignored build directory, all
at once, and its ``pyc_row_tile_pass`` is launched directly (the split
count of ``pyc_row_tile_splits``) on the 10,000 x 100,000 matrix of
``chip_smoke.py``. The cases: at k = 1 the three matvecs (int8 centered
with ``fill - mu``, as ``apply_weighted_cov`` calls it; int8 uncentered
with and without a fill, as ``storage_matvec`` and ``scores_dirfix_pass``
do; float32+NaN with a fill), then int8 at k = 12 with and without a
fill, k = 5 centered, and float32+NaN at k = 12. Medians of 10 CUDA-event
timings, two rounds, each beside its bound (one read of X and the vectors
at 3.35 TB/s, or 2kRE float32 operations at 67 TFLOP/s), and, for the
variants that sum, the largest error on the first and last 256 rows
against a float64 product over max(max |ref|, 1). Compare variants only
within one call.

``--device-refs`` keeps the float64 references on the card while the
variants launch (the lab's first flow, in which the first case's
reference was twice found overwritten by the end of the run) and checks
at the end that each still equals its host copy bit for bit (with or
without ``CUDA_LAUNCH_BLOCKING=1``).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "pyconsensus_tpu_torch", "csrc")
OUT = os.path.join(CSRC, "build", "lab")
R, E = 10_000, 100_000
NAMES = ("base", "copy_only", "compute_only", "fma_only", "i2f",
         "one_block")

_CHUNK_COPY = "    if (nx < n)\n      stage_chunk"
_SLICE_EXIT = "      if (e0 + s0 >= E) break;"
_V_LOAD = "v[c] = *reinterpret_cast<const float4*>(vs + c * BK + col);"
_DECODE = "        decode4(xs + r * BK + col, val, absent);"
_BLOCKS = "  return K == 1 ? 2 : 1;"
_STAGES = """             ? kStages
             : 2;"""
_BYTE_TRICK = """    val[j] = fmaf(__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440u + j)),
                  0.5f, -4194368.f);"""


def _edit(text: str, old: str, new: str) -> str:
    if old not in text:
        raise RuntimeError(f"the source no longer holds {old!r}")
    return text.replace(old, new)


def variants(src: str) -> dict:
    compute = _edit(src, _CHUNK_COPY, "    if (false)\n      stage_chunk")
    fma = _edit(_edit(compute, _V_LOAD, _V_LOAD.replace("c * BK + ", "")),
                _DECODE, "        for (int j = 0; j < 4; ++j) {\n"
                "          val[j] = __int_as_float(0x3f000000 + lane + r * 4"
                " + j);\n          absent[j] = false;\n        }")
    return {
        "base": src,
        "copy_only": _edit(src, _SLICE_EXIT, "      break;"),
        "compute_only": compute,
        "fma_only": fma,
        "one_block": _edit(_edit(src, _BLOCKS, "  return 1;"), _STAGES,
                           "             ? kStages\n             : kStages;"),
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
    """One line per row-pass instantiation at k <= 1 of an ``-Xptxas -v``
    report (the row-tile kernel at k = 1, or the parent's row pass): its
    template arguments, registers and spill bytes."""
    rows, entry, spill = [], None, ""
    for ln in text.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else ln
            entry = name if ("row_pass_kernel" in name or (
                "row_tile_kernel" in name and "Li1EE" in name)) else None
        elif entry and "spill stores" in ln:
            spill = ln.strip()
        elif entry and "Used" in ln and "registers" in ln:
            args = entry.split("kernelI", 1)[-1].split("EEv", 1)[0]
            regs = ln.split("Used", 1)[1].split("registers")[0].strip()
            rows.append(f"{args}: {regs} registers; {spill}")
            entry = None
    return rows


def launcher(torch, name, path, x, k, m, a, vt, n_sm):
    """A function that runs the variant's row pass once on ``x``."""
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib = ctypes.CDLL(path)
    dev = x.device
    stream = torch.cuda.current_stream().cuda_stream
    is8 = int(x.dtype == torch.int8)
    t = torch.empty((k, R), device=dev)
    if name == "parent":
        # the parent's pass: one vector, a mean always (zeros uncentered)
        run = lib.pyc_row_pass
        run.argtypes = [P, I, LL, LL, P, P, P, P, P]
        mean = m if m is not None else torch.zeros(E, device=dev)
        args = (x.data_ptr(), is8, R, E, mean.data_ptr(),
                None if a is None else a.data_ptr(), vt.data_ptr(),
                t.data_ptr(), stream)
    else:
        run = lib.pyc_row_tile_pass
        run.argtypes = [P, I, LL, LL, P, P, P, I, I, P, P, P]
        lib.pyc_row_tile_splits.argtypes = [LL, LL, I, I]
        S = lib.pyc_row_tile_splits(R, E, is8, n_sm)
        part = torch.empty((S, k, R), device=dev)
        args = (x.data_ptr(), is8, R, E,
                None if m is None else m.data_ptr(),
                None if a is None else a.data_ptr(), vt.data_ptr(), k, S,
                part.data_ptr(), t.data_ptr(), stream)
    run.restype = I

    def once():
        if run(*args) != 0:
            raise RuntimeError(f"{name}: launch failed")
        return t

    return once


def main(argv=None) -> int:
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("names", nargs="*", default=list(NAMES))
    ap.add_argument("--parent", default=None,
                    help="root of a checkout whose row pass is timed as the "
                    "'parent' variant")
    ap.add_argument("--device-refs", action="store_true",
                    help="keep the float64 references on the card and "
                    "check at the end that none changed")
    args = ap.parse_args(argv)
    names = list(args.names)
    if args.parent and "parent" not in names:
        names.append("parent")
    if "parent" in names and not args.parent:
        ap.error("the parent variant needs --parent")
    if not torch.cuda.is_available():
        print("row_tile_lab: no CUDA device", file=sys.stderr)
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
    vts = {k: torch.randn((k, E), generator=g, device=dev)
           for k in (1, 5, 12)}
    cases = (("int8 k=1 centered", x8, 1, mu, a),
             ("int8 k=1", x8, 1, None, fill),
             ("int8 k=1 no fill", x8, 1, None, None),
             ("float32 k=1", xf, 1, None, fill),
             ("int8 k=12", x8, 12, None, fill),
             ("int8 k=12 no fill", x8, 12, None, None),
             ("int8 k=5 centered", x8, 5, mu, a),
             ("float32 k=12", xf, 12, None, fill))
    # the float64 references, taken before any launch and kept on the host
    # (with --device-refs on the card, their host copies kept apart)
    rows = torch.cat([torch.arange(256), torch.arange(R - 256, R)]).to(dev)
    refs, host_refs = {}, {}
    for case, x, k, m, av in cases:
        xs = x[rows]
        val = xs.double() * 0.5 if x.dtype == torch.int8 else xs.double()
        absent = xs < 0 if x.dtype == torch.int8 else xs.isnan()
        xc = val - m.double() if m is not None else val
        if av is not None:
            xc = torch.where(absent, av.double()[None, :], xc)
        ref = vts[k].double() @ xc.T
        host_refs[case] = ref.cpu()
        refs[case] = ref if args.device_refs else host_refs[case]
        del xs, val, absent, xc
    times, errs = {}, {}
    for _ in range(2):
        for name, path in libs.items():
            for case, x, k, m, av in cases:
                if name == "parent" and k != 1:
                    continue
                once = launcher(torch, name, path, x, k, m, av, vts[k], n_sm)
                got = once()[:, rows].double()
                if name not in ("copy_only", "compute_only"):
                    ref = refs[case]
                    got = got.to(ref.device)
                    errs[name, case] = float((got - ref).abs().max()) / max(
                        float(ref.abs().max()), 1.0)
                times.setdefault((name, case), []).append(
                    cs.time_ms(torch, once, 10))
    for (name, case), ms in times.items():
        x = xf if case.startswith("float32") else x8
        k = int(case.split("k=")[1].split()[0])
        n_vec = 1 + (" centered" in case) + ("no fill" not in case)
        b_ms, b_by = cs.bound_ms(x.numel() * x.element_size()
                                 + 4 * (k + n_vec) * E + 4 * k * R,
                                 2 * k * R * E)
        err = errs.get((name, case))
        print(f"{name:13s} {case:18s} " + " ".join(f"{t:.4f}" for t in ms)
              + f" ms (bound {b_ms:.4f} {b_by}"
              + (f", err {err:.1e}" if err is not None else "")
              + f") on {card}")
    if args.device_refs:
        torch.cuda.synchronize()
        moved = [case for case in refs
                 if not torch.equal(refs[case].cpu(), host_refs[case])]
        print(f"device references unchanged after every launch: "
              f"{not moved}" + (f" (changed: {moved})" if moved else ""),
              flush=True)
        if moved:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
