"""The yardstick's arithmetic: the roofline bounds of PERF.md's kernel
table, the end-to-end metrics over a job log, the trace reduction."""

import types

import pytest

from portbench import harness, roofline, trace


def test_bounds_at_8192_lookup_50():
    for fast, ms in ((False, 3.19), (True, 1.02)):
        w = roofline.geomorphons_work(8192, 8192, 50, fast=fast)
        t, side = roofline.bound_seconds(w["ops"], w["bytes"])
        assert side == "operations"
        assert round(t * 1e3, 2) == ms


def _reader(name):
    return harness.load_module(harness.BASE / "metrics" / f"{name}.py",
                               f"t_{name}")


def _run(durations, px=1_000_000):
    jobs, t = [], 100.0
    for d in durations:
        jobs.append((t, t + d))
        t += d
    return harness.Run(jobs=jobs, window_s=t - 100.0, setup_s=1.0,
                       pixels_per_job=px, counters={}, work=None,
                       trace=None, config={}, traffic={})


def test_rate_is_over_the_whole_window_and_the_tail_sees_stalls():
    rate, p95 = _reader("raster_mpix_s"), _reader("job_p95_ms")
    steady = _run([0.01] * 100)
    stalled = _run([0.01] * 90 + [0.5] * 10)
    assert rate.read(steady) == pytest.approx(100.0)
    # the stalls' seconds count in full: 100 Mpx over 5.9 s
    assert rate.read(stalled) == pytest.approx(100 / 5.9)
    assert p95.read(steady) == pytest.approx(10.0)
    assert p95.read(stalled) == pytest.approx(500.0)
    one = _run([0.01] * 99 + [0.5])
    assert p95.read(one) == pytest.approx(10.0)
    assert rate.read(one) < rate.read(steady)


def _ev(name, start, dur, cuda, ann=False):
    import torch
    kind = (torch.autograd.DeviceType.CUDA if cuda
            else torch.autograd.DeviceType.CPU)
    return types.SimpleNamespace(
        name=lambda: name, start_ns=lambda: start, duration_ns=lambda: dur,
        device_type=lambda: kind, is_user_annotation=lambda: ann)


def test_trace_record_busy_idle_and_labels():
    p = "portbench."
    evs = [_ev(p + "job", 0, 100, False, True),
           _ev(p + "call", 0, 20, False, True),
           _ev(p + "sync", 20, 80, False, True),
           _ev("kernel_a", 10, 40, True), _ev("kernel_b", 30, 30, True),
           _ev("Memcpy HtoD", 70, 10, True),
           _ev(p + "job", 100, 100, False, True),
           _ev(p + "call", 100, 100, False, True),
           _ev("gpu annotation", 0, 100, True, True)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: evs)))
    rec = trace.Record(prof, [None, {"split": ("moments", "tile loop",
                                               60e-9)}])
    assert rec.busy == [[10, 60], [70, 80]]
    assert rec.busy_per_job() == [60e-9, 0.0]
    assert rec.window_s() == 200e-9 and rec.busy_s() == 60e-9
    assert rec.copy_s() == 10e-9
    b = rec.breakdown()
    assert b["device_ops"][0] == ["kernel_a", 40e-9]
    idle = dict(b["idle_gaps"])
    assert idle["job/call"] == pytest.approx(10e-9)
    assert idle["job/sync"] == pytest.approx(30e-9)
    assert idle["job/call/moments"] == pytest.approx(40e-9)
    assert sum(idle.values()) == pytest.approx(140e-9)
    assert idle["job/call/tile loop"] == pytest.approx(60e-9)
