#!/usr/bin/env python3
"""Where the row-tile pass's time goes: variants of
``pyconsensus_tpu_torch/csrc/storage_sweeps.cu`` that each drop one part
of ``row_tile_kernel``, timed on one card against the kernel as it is.

    python3 tools/row_tile_lab.py                  # every variant
    python3 tools/row_tile_lab.py base compute_only

Variants (each a text edit of the source, asserted to apply):

- ``base``: the source as it is;
- ``copy_only``: the chunks are copied, nothing is summed;
- ``compute_only``: only the first two chunks are copied, every chunk is
  summed (from whatever the stages hold);
- ``fma_only``: ``compute_only`` with the entries made in registers and
  one V load a slice, so that the FMAs alone remain;
- ``i2f``: the int8 decode through an int-to-float conversion instead of
  the byte-into-mantissa trick.

Each variant is built with ``nvcc`` into the ignored build directory, all
at once, and its ``pyc_row_tile_pass`` is launched directly (the split
count of ``pyc_row_tile_splits``) on the 10,000 x 100,000 matrix of
``chip_smoke.py``: int8 at k = 1 and 12 with a fill vector, k = 12
without, k = 5 centered, and float32+NaN at k = 12. Medians of 10
CUDA-event timings, two rounds. Compare variants only within one call.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "pyconsensus_tpu_torch", "csrc")
OUT = os.path.join(CSRC, "build", "lab")
R, E = 10_000, 100_000
NAMES = ("base", "copy_only", "compute_only", "fma_only", "i2f")

_CHUNK_COPY = "    if (nx < n)\n      stage_chunk"
_SLICE_EXIT = "      if (e0 + s0 >= E) break;"
_V_LOAD = "v[c] = *reinterpret_cast<const float4*>(vs + c * BK + col);"
_DECODE = "        decode4(xs + r * BK + col, val, absent);"
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
        "i2f": _edit(src, _BYTE_TRICK, "    val[j] = static_cast<float>("
                     "static_cast<int8_t>((w >> (8 * j)) ^ 0x80u)) * 0.5f;"),
    }


def build(names) -> dict:
    from pyconsensus_tpu_torch.ops.build import (ARCH_FLAGS, NVCC_FLAGS,
                                                 nvcc_path)

    src = open(os.path.join(CSRC, "storage_sweeps.cu")).read()
    table = variants(src)
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name in names:
        cu = os.path.join(OUT, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(table[name])
        lib = os.path.join(OUT, f"lib{name}.so")
        procs[name] = (cu, lib, subprocess.Popen(
            [nvcc_path(), *ARCH_FLAGS, *NVCC_FLAGS, "-I", CSRC, "-o", lib,
             cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (_, lib, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{text[-4000:]}")
        libs[name] = lib
    return libs


def main(argv=None) -> int:
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    names = argv or list(NAMES)
    if not torch.cuda.is_available():
        print("row_tile_lab: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    libs = build(names)
    dev = torch.device("cuda")
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
    cases = (("int8 k=1", x8, 1, None, fill),
             ("int8 k=12", x8, 12, None, fill),
             ("int8 k=12 no fill", x8, 12, None, None),
             ("int8 k=5 centered", x8, 5, mu, a),
             ("float32 k=12", xf, 12, None, fill))
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    stream = torch.cuda.current_stream().cuda_stream
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    times = {}
    for _ in range(2):
        for name, path in libs.items():
            lib = ctypes.CDLL(path)
            run = lib.pyc_row_tile_pass
            run.argtypes = [P, I, LL, LL, P, P, P, I, I, P, P, P]
            run.restype = I
            lib.pyc_row_tile_splits.argtypes = [LL, LL, I, I]
            for case, x, k, m, fv in cases:
                is8 = int(x.dtype == torch.int8)
                S = lib.pyc_row_tile_splits(R, E, is8, n_sm)
                part = torch.empty((S, k, R), device=dev)
                t = torch.empty((k, R), device=dev)
                args = (x.data_ptr(), is8, R, E,
                        None if m is None else m.data_ptr(),
                        None if fv is None else fv.data_ptr(),
                        vts[k].data_ptr(), k, S, part.data_ptr(),
                        t.data_ptr(), stream)
                if run(*args) != 0:
                    raise RuntimeError(f"{name} {case}: launch failed")
                torch.cuda.synchronize()
                times.setdefault((name, case), []).append(
                    cs.time_ms(torch, lambda: run(*args), 10))
    for (name, case), ms in times.items():
        print(f"{name:13s} {case:18s} " + " ".join(f"{t:.4f}" for t in ms)
              + f" ms on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
