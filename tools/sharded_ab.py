#!/usr/bin/env python3
"""The sharded overhead in several source trees, in turns: the
``sharded_geomorphons`` call on a 2 x 2 mesh naming the card four times
over the single-device ``geomorphons`` call (8192^2, lookup 50,
``chip_smoke.bench_input``), medians of 9 CUDA-event runs in turns.

Run on a machine with a card, from the root of a checkout; each tree
holds ``chip_smoke.py`` and its package (this checkout, ``.``, or a
``git archive`` of another commit unpacked under ``build/``) and runs in
a process of its own, building its kernels::

    python3 tools/sharded_ab.py build/parent . . build/parent

Prints one JSON line per tree: both medians, their ratio and the runs.
"""
import subprocess
import sys

CODE = r'''
import json, statistics, sys
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
import neilpy_tpu_torch as ntt
from neilpy_tpu_torch import _build
_build.build()
_build.load()
dev = torch.device("cuda", 0)
Z = torch.from_numpy(cs.bench_input((8192, 8192))).to(dev)
mesh = ntt.dist.make_mesh([dev] * 4)
kw = dict(cellsize=10.0, lookup_pixels=50, threshold_angle=1)
fns = {"single": lambda: ntt.geomorphons(Z, **kw),
       "sharded": lambda: ntt.dist.sharded_geomorphons(Z, mesh, **kw)}
cs.TIMED_RUNS = 9
t = cs.time_turns(fns, lambda f: f())
med = {k: statistics.median(v) for k, v in t.items()}
print(json.dumps({"single_ms": med["single"], "sharded_ms": med["sharded"],
                  "ratio": med["sharded"] / med["single"], "runs": t,
                  "card": cs.card_line()}))
'''


def main(trees):
    for tree in trees:
        out = subprocess.run([sys.executable, "-c", CODE], cwd=tree,
                             capture_output=True, text=True, check=False)
        lines = out.stdout.strip().splitlines()
        print(tree, lines[-1] if out.returncode == 0 and lines
              else f"failed (rc {out.returncode}): {out.stderr[-2000:]}",
              flush=True)
        if out.returncode:
            return out.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or ["."]))
