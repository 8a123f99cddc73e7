#!/usr/bin/env python3
"""Run one cell of the benchmark on the CUDA card(s) of this machine.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics; with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``: each number compared with the reference beside its
limit, which also close standard error.  Exits non-zero with no result
line when no CUDA card (or fewer than the cell asks for) is present,
when the port cannot be imported, or when JAX or the JAX package is in
``sys.modules`` once the window has closed.

Every build and kernel cache stays inside the checkout
(``build/portbench/``); temporary files go under ``TMPDIR`` and are
removed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "nv_compute_cache")):
    os.environ[var] = str(ROOT / "build" / "portbench" / sub)
sys.path.insert(0, str(ROOT))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def card_line():
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    import subprocess
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read: {e}"
    return res.stdout.strip().splitlines()[0] if res.stdout.strip() else \
        f"not read: {res.stderr.strip()[:200]}"


def main(argv=None):
    args = parse_args(argv)
    import torch
    from portbench import harness

    chips = harness.CellSpec(args.workload).entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {chips} CUDA device(s), found {n}", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda:0", T_START)
    banned = harness.banned_modules()
    if banned:
        print(f"the run loaded {', '.join(banned)}", file=sys.stderr)
        return 3
    card = card_line()
    print(f"card: {card}", file=sys.stderr)
    checks = out.pop("checks")
    out["card"] = card
    out["checks"] = checks
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
