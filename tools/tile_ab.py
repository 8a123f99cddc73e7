"""Same-call timing of K1's and K5/counts' tile path across source trees.

Usage (on a machine with a CUDA card)::

    python3 tools/tile_ab.py ROOT [ROOT ...]

Each ROOT is a checkout of this repository (the current one, or another
commit unpacked with ``git archive`` into a git-ignored directory).  The
kernels of every ROOT are built first, all at once; then each ROOT, in the
order given (list the trees as A B B A to see drift), runs in a process
of its own that imports that tree's ``neilpy_tpu_torch`` and times, with
CUDA events in turns (median of ``RUNS`` after one warm-up each), at
8192^2, lookup 50, on ``chip_smoke.py``'s input: K5/counts on the exact
ladder and K1 on the fast and the exact ladder, each with the tile path
on (both of its load paths where the tree has ``cuda_scan._tile_load``:
``tma``, and ``cp.async`` forced) and off (``per_thread``).  The counts
of every variant must equal the first's.  One JSON line per ROOT and
kernel on stdout, also appended to ``chiprun_out/tile_ab.jsonl``.
"""

import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

RUNS = 11
SHAPE = (8192, 8192)
LOOKUP = 50


def _worker(root):
    import contextlib

    import numpy as np
    import torch

    sys.path.insert(0, root)
    from neilpy_tpu_torch.ops import cuda_scan
    assert Path(cuda_scan.__file__).resolve().is_relative_to(
        Path(root).resolve()), cuda_scan.__file__

    @contextlib.contextmanager
    def switched(name, value):
        saved = getattr(cuda_scan, name)
        setattr(cuda_scan, name, value)
        try:
            yield
        finally:
            setattr(cuda_scan, name, saved)

    variants = {"tile": contextlib.nullcontext}
    if hasattr(cuda_scan, "_tile_load"):
        variants = {"tma": contextlib.nullcontext,
                    "cp.async": lambda: switched("_tile_load", lambda Z: 0)}
    variants["per_thread"] = lambda: switched("_ALLOW_TILE", False)

    Z = np.random.default_rng(0).normal(size=SHAPE).astype(np.float32)
    Z = np.cumsum(Z, axis=0) + np.cumsum(Z, axis=1)
    Zd = torch.from_numpy(Z).cuda()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    cases = (("K5/counts exact", cuda_scan.openness_counts_plan_cuda, False),
             ("K1 fast", cuda_scan.openness_counts_cuda, True),
             ("K1 exact", cuda_scan.openness_counts_cuda, False))
    for name, fn, fast in cases:
        def call(v):
            with variants[v]():
                return fn(Zd, cellsize=10.0, lookup_pixels=LOOKUP,
                          threshold_angle=1.0, fast=fast)
        want = [t.clone() for t in call(next(iter(variants)))]
        for v in variants:
            got = call(v)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(got, want)), \
                f"{name} {v} differs from {next(iter(variants))}"
            del got
        times = {v: [] for v in variants}
        keys = list(variants)
        for rep in range(RUNS):
            for v in keys if rep % 2 == 0 else keys[::-1]:
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                call(v)
                stop.record()
                stop.synchronize()
                times[v].append(start.elapsed_time(stop))
        line = json.dumps({
            "root": root, "kernel": name, "shape": list(SHAPE),
            "lookup": LOOKUP, "card": card.strip(),
            "median_ms": {v: statistics.median(t) for v, t in times.items()},
            "runs": times})
        print(line, flush=True)
        out = Path("chiprun_out")
        out.mkdir(exist_ok=True)
        with open(out / "tile_ab.jsonl", "a") as f:
            f.write(line + "\n")


def main(roots):
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    build = ("import sys; sys.path.insert(0, sys.argv[1]); "
             "from neilpy_tpu_torch import _build; _build.build()")
    procs = [subprocess.Popen([sys.executable, "-c", build, r])
             for r in dict.fromkeys(roots)]
    if any(p.wait() for p in procs):
        return 1
    for root in roots:
        rc = subprocess.run([sys.executable, __file__, "--worker", root],
                            env=dict(os.environ)).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        _worker(sys.argv[2])
    else:
        sys.exit(main(sys.argv[1:]))
