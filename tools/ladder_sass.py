#!/usr/bin/env python3
"""Instructions per ladder step in the port's compiled kernels.

Run on a machine with the CUDA toolkit, from the root of a checkout::

    python3 tools/ladder_sass.py [source ...]

Each source (default: the five of ``neilpy_tpu_torch/csrc`` that hold
tile kernels, ``openness_counts``, ``openness_counts_plan``,
``directional_extrema``, ``openness_counts_block`` and
``openness_reduced_tile``, whose tile kernels K2 and K5/reduced share,
and the per-thread bodies of K2 and K5/reduced, ``openness_reduced`` and
``openness_reduced_plan``) is compiled to a cubin with the package's own
nvcc flags (``neilpy_tpu_torch/_build.py``), disassembled with
``cuobjdump -sass``, and every loop of every kernel (a backward branch)
is reported as its instruction count, its global loads (``LDG``), its
shared loads (``LDS``) and its pixel-steps (one ``FMUL`` per pixel and
ladder step), so a masked step (ladder entry, Z and scale loads, two
compare-selects), a maskless step (Z and scale loads, max, min) and the
tile body's step (ladder_tile.cuh: one shared load per pixel, sub, mul,
max, min, and one table load per thread for its pixels) can be told
apart and counted.  In a tile kernel the step loop is the one with 32
pixel-steps and 36 ``LDS``; the direction loop around it is reported
too, its count including the epilogue's own ``FMUL``s (the reduced
fold's).  One JSON line per kernel: ``{"source", "kernel",
"instructions", "registers", "spill_stores", "spill_loads", "loops":
[[instructions, LDG, LDS, pixel_steps, instructions_per_pixel_step,
count], ...]}``, the commonest loops first; registers and spill bytes are
ptxas's (``-Xptxas -v``, read by ``_build.ptxas_summary``).
"""

import json
import re
import subprocess
import sys
import tempfile
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from neilpy_tpu_torch import _build  # noqa: E402

INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);")


def loops(sass):
    """[(instructions, LDG, LDS, FMUL, instructions per FMUL), ...] of
    every backward-branch loop."""
    code = [(int(a, 16), ins.strip()) for a, ins in INSTR.findall(sass)]
    at = {a: k for k, (a, _) in enumerate(code)}
    out = []
    for k, (a, ins) in enumerate(code):
        target = re.search(r"BRA\s+(?:`\(\S+\)\s*)?0x([0-9a-f]+)", ins)
        if not target or int(target.group(1), 16) >= a:
            continue
        body = [i for _, i in code[at.get(int(target.group(1), 16), k):k + 1]]
        steps = sum(bool(re.search(r"(^|\s)FMUL\b", i)) for i in body)
        out.append((len(body), sum("LDG" in i for i in body),
                    sum(bool(re.search(r"(^|\s)LDS\b", i)) for i in body),
                    steps, round(len(body) / steps, 3) if steps else None))
    return len(code), out


def main(sources):
    nvcc = _build._nvcc()
    cuobjdump = str(Path(nvcc).parent / "cuobjdump")
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        for src in sources:
            cubin = Path(tmp) / f"{src}.cubin"
            built = subprocess.run([nvcc, *flags, "-cubin", "-o", str(cubin),
                                    str(_build.SOURCE_DIR / f"{src}.cu")],
                                   capture_output=True, text=True, check=True)
            regs = {fn: rest for fn, *rest in
                    _build.ptxas_summary(built.stdout + built.stderr)}
            sass = subprocess.run([cuobjdump, "-sass", str(cubin)],
                                  capture_output=True, text=True,
                                  check=True).stdout
            for fn in re.split(r"\n\s+Function : ", sass)[1:]:
                name = fn.split("\n")[0].strip()
                n, found = loops(fn)
                r, st, ld = regs.get(name, (None, None, None))
                print(json.dumps({
                    "source": src, "kernel": name, "instructions": n,
                    "registers": r, "spill_stores": st, "spill_loads": ld,
                    "loops": [[*key, c] for key, c in
                              Counter(found).most_common()]}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or ["openness_counts", "openness_counts_plan",
                          "directional_extrema", "openness_counts_block",
                          "openness_reduced_tile", "openness_reduced",
                          "openness_reduced_plan"])
