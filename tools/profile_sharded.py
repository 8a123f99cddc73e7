#!/usr/bin/env python3
"""Where the time of the sharded calls goes on one CUDA card.

Run on a machine with a CUDA card, from the root of a checkout::

    python3 tools/profile_sharded.py

It builds the kernels, puts ``chip_smoke.py``'s input (8192^2, lookup 50,
cellsize 10) on the card, and profiles with ``torch.profiler`` (CPU and
CUDA activities), each after a warm-up, one call of each of:
``dist.sharded_geomorphons`` and ``dist.sharded_openness`` on a 2 x 2 mesh
naming the card four times, and the single-device ``geomorphons`` and
``openness`` for comparison.  The package's steps are wrapped, here only,
in ``torch.profiler.record_function`` ranges: the halo exchange
(``halo_exchange_2d``), the ladder kernel (K4's ``openness_counts_block``,
K3's ``directional_extrema``; the single-device calls' ``openness_counts``
and ``openness_reduced``), the rest of ``directional_ratio_extrema``
(the ``seen`` mask), the per-block classify (``classes_from_counts``),
the assembly (``_assemble``, with its crop); each device activity (kernel,
memcpy, memset) goes to the innermost range around its launch, and what
no range holds (the padding, the openness epilogue) to ``other``.

One JSON line per call: ``wall_ms`` (host clock around the call, ending in
a synchronise), ``device_ms`` (the union of the device activities' spans),
``idle_share`` (1 - device_ms / wall_ms), ``ms_by_step`` (device time per
step, summed over its activities) and ``launches_by_step``; then a line
with the sharded / single ratios of the walls.  Each line is also
appended to ``chiprun_out/profile_sharded.jsonl``.
"""

import contextlib
import functools
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def emit(**record):
    line = json.dumps(record)
    print(line, flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    with open(out / "profile_sharded.jsonl", "a") as f:
        f.write(line + "\n")


@contextlib.contextmanager
def ranges():
    """Wrap the steps of the sharded calls in record_function ranges named
    after them, for the length of the block."""
    from neilpy_tpu_torch.dist import api
    from neilpy_tpu_torch.ops import visibility
    steps = [(api, "halo_exchange_2d", "halo"),
             (api, "openness_counts_block", "ladder"),
             (visibility, "directional_extrema", "ladder"),
             (api, "directional_ratio_extrema", "extrema_rest"),
             (api, "classes_from_counts", "classify"),
             (api, "_assemble", "assemble"),
             (visibility, "openness_counts", "ladder"),
             (visibility, "openness_reduced", "ladder")]
    saved = []
    for mod, name, step in steps:
        fn = getattr(mod, name)

        @functools.wraps(fn)
        def wrapped(*a, _fn=fn, _step=step, **kw):
            with torch.profiler.record_function(f"step:{_step}"):
                return _fn(*a, **kw)
        saved.append((mod, name, fn))
        setattr(mod, name, wrapped)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def attribute(trace):
    """(device_ms, ms_by_step, launches_by_step) of a chrome trace: each
    device activity goes to the innermost ``step:`` range whose CPU span
    holds the runtime call that launched it (matched by correlation id)."""
    events = trace["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"][5:])
                   for e in events if e.get("cat") == "user_annotation"
                   and e.get("name", "").startswith("step:"))
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") == "cuda_runtime"
                 and "correlation" in e.get("args", {})}
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    by_step, launches = {}, {}
    for e in device:
        ts = launch_ts.get(e.get("args", {}).get("correlation"))
        step = "other"
        if ts is not None:
            inside = [s for s in spans if s[0] <= ts <= s[1]]
            if inside:
                step = min(inside, key=lambda s: s[1] - s[0])[2]
        by_step[step] = by_step.get(step, 0.0) + e["dur"] / 1e3
        launches[step] = launches.get(step, 0) + 1
    busy, end = 0.0, None
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in device):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e3, by_step, launches


def profile(name, call):
    call()  # warm-up (tile routes, halo buffers, allocator)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        trace = json.loads(path.read_text())
    device_ms, by_step, launches = attribute(trace)
    emit(call=name, wall_ms=wall, device_ms=device_ms,
         idle_share=1.0 - device_ms / wall,
         ms_by_step=dict(sorted(by_step.items(), key=lambda kv: -kv[1])),
         launches_by_step=launches)
    return wall


def main():
    if not torch.cuda.is_available():
        print("profile_sharded: no CUDA device", file=sys.stderr)
        return 1
    import neilpy_tpu_torch as ntt
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    emit(card=chip_smoke.card_line(), torch=torch.__version__)
    Zd = torch.from_numpy(chip_smoke.bench_input(chip_smoke.MAIN_SHAPE)).to(
        dev)
    mesh = ntt.dist.make_mesh([dev] * 4)
    kw = dict(cellsize=10.0, lookup_pixels=chip_smoke.MAIN_LOOKUP)
    # one profiled window first: it carries the profiler's start-up
    profile("start-up", lambda: ntt.geomorphons(Zd, threshold_angle=1, **kw))
    walls = {}
    with ranges():
        for name, call in (
                ("sharded_geomorphons 2x2", lambda: ntt.dist
                 .sharded_geomorphons(Zd, mesh, threshold_angle=1, **kw)),
                ("geomorphons", lambda: ntt.geomorphons(
                    Zd, threshold_angle=1, **kw)),
                ("sharded_openness 2x2", lambda: ntt.dist.sharded_openness(
                    Zd, mesh, **kw)),
                ("openness", lambda: ntt.openness(Zd, **kw))):
            walls[name] = profile(name, call)
    emit(ratio={"geomorphons": walls["sharded_geomorphons 2x2"]
                / walls["geomorphons"],
                "openness": walls["sharded_openness 2x2"]
                / walls["openness"]},
         over="host-clock wall of one profiled call each")
    return 0


if __name__ == "__main__":
    sys.exit(main())
