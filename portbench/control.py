#!/usr/bin/env python3
"""Readings that set a cell's limits: the program's and its control's.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 \
        [--seconds 3]

For each seed, in one process: the cell's inputs at its own size, a
short closed-loop window of the timed path judged as a run judges it
(the program's reading), then the control judged the same way: the
reference computed in bfloat16 put in the program's place
(``geomorphons_l50``), or the program's own lower precision, the compact
wire that ships Moran as bfloat16 (``mosaic_trio``).  Prints one JSON
line per seed.  The benchmark's own runs do not run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def readings(name, seed, seconds, device, overrides=None):
    """{"program": numbers, "control": numbers} for one seed."""
    from portbench import harness
    cell, config, traffic, dut = harness.prepare(name, seed, device,
                                                 overrides=overrides)
    limits = config["limits"]
    span = harness.spans(False)
    try:
        dut.warm(span)
        jobs, _ = harness.closed_loop(dut, seconds, span)
        reference = cell.reference()
        program, failed = dut.judge(reference, limits)
        control, control_failed = dut.control(reference, limits)
    finally:
        dut.close()
    return {"seed": seed, "jobs": len(jobs), "program": program,
            "program_failed": failed, "control": control,
            "control_failed": control_failed, "limits": limits}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t = time.perf_counter()
        out = readings(args.workload, seed, args.seconds, "cuda:0")
        out["seconds"] = time.perf_counter() - t
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
