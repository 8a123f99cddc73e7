#!/usr/bin/env python3
"""Instructions per ladder step in the port's compiled kernels.

Run on a machine with the CUDA toolkit, from the root of a checkout::

    python3 tools/ladder_sass.py [source ...]

Each source (default: the four that run the tile body,
``openness_counts``, ``openness_counts_plan``, ``directional_extrema`` and
``openness_counts_block`` of ``neilpy_tpu_torch/csrc``) is compiled to a
cubin with the package's
own nvcc flags (``neilpy_tpu_torch/_build.py``), disassembled with
``cuobjdump -sass``, and every loop of every kernel (a backward branch)
is reported as its instruction count, its global loads (``LDG``), its
shared loads (``LDS``) and its pixel-steps (one ``FMUL`` per pixel and
ladder step), so a masked step (ladder entry, Z and scale loads, two
compare-selects), a maskless step (Z and scale loads, max, min) and the
tile body's step (ladder_tile.cuh: one shared load per pixel, sub, mul,
max, min, and one table load per thread for its pixels) can be told
apart and counted.  One JSON line per kernel: ``{"source", "kernel",
"instructions", "loops": [[instructions, LDG, LDS, pixel_steps,
instructions_per_pixel_step, count], ...]}``, the commonest loops first.
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
    flags = [f for f in _build.NVCC_FLAGS
             if f not in ("-Xcompiler", "-fPIC", "-Xptxas", "-v")]
    with tempfile.TemporaryDirectory() as tmp:
        for src in sources:
            cubin = Path(tmp) / f"{src}.cubin"
            subprocess.run([nvcc, *flags, "-cubin", "-o", str(cubin),
                            str(_build.SOURCE_DIR / f"{src}.cu")], check=True)
            sass = subprocess.run([cuobjdump, "-sass", str(cubin)],
                                  capture_output=True, text=True,
                                  check=True).stdout
            for fn in re.split(r"\n\s+Function : ", sass)[1:]:
                n, found = loops(fn)
                print(json.dumps({
                    "source": src, "kernel": fn.split("\n")[0].strip(),
                    "instructions": n,
                    "loops": [[*key, c] for key, c in
                              Counter(found).most_common()]}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or ["openness_counts", "openness_counts_plan",
                          "directional_extrema", "openness_counts_block"])
