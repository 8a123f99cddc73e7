"""The readers of the spline coefficients' two per-layer metrics,
``smrf.spline_ms_per_call`` and ``spline.kernel_sweep_pct``, on
hand-built span records, and their manifest entries."""

import json
import types

import pytest

from portbench import harness

from .conftest import ROOT

MS = 1_000_000
CELL = "smrf_isprs.tile5m"
NAMES = ["smrf.spline_ms_per_call", "spline.kernel_sweep_pct"]


def _reader(name):
    return harness.load_module(harness.BASE / "metrics" / f"{name}.py",
                               f"t_{name}")


def span(name, t0, t1, sid, parent=None, root=None, device_ms=None,
         attr=None):
    return types.SimpleNamespace(name=name, start_ns=t0, end_ns=t1, id=sid,
                                 parent=parent, root=root or sid,
                                 device_ms=device_ms, attr=attr,
                                 thread="MainThread")


def call(base, sid, spline_ms, paths):
    """One ``smrf.call`` of 1 s from ``base`` ms: an ``smrf.spline`` span
    of ``spline_ms`` device ms and under it one ``spline.thomas`` span a
    path in ``paths`` (None: no ``attr``)."""
    t = base * MS
    out = [span("smrf.call", t, t + 1000 * MS, sid),
           span("smrf.spline", t + 800 * MS, t + 900 * MS, sid + 1, sid, sid,
                spline_ms)]
    for k, path in enumerate(paths):
        out.append(span("spline.thomas", t + (800 + k) * MS,
                        t + (801 + k) * MS, sid + 2 + k, sid + 1, sid, 0.1,
                        None if path is None else {"path": path}))
    return out


def traced_run():
    """A traced run whose window is [0, 2 s)."""
    trace = types.SimpleNamespace(window=(0, 2000 * MS), busy=[])
    return harness.Run(jobs=[], trace=trace)


@pytest.fixture
def spans(monkeypatch):
    from neilpy_tpu_torch import profiling

    def use(record):
        monkeypatch.setattr(profiling, "spans", lambda: list(record))
    return use


def test_spline_ms_per_call(spans):
    read = _reader("smrf.spline_ms_per_call").read
    # two calls in the window (3 + 5 ms of spline), one outside it, and a
    # spline span under no call
    record = (call(0, 1, 3.0, ["cuda"] * 6) + call(1000, 20, 5.0,
                                                   ["cuda"] * 6)
              + call(3000, 40, 99.0, ["eager"] * 6)
              + [span("smrf.spline", 1950 * MS, 1960 * MS, 60,
                      device_ms=50.0)])
    spans(record)
    run = traced_run()
    assert read(run) == pytest.approx(4.0)
    assert read(harness.Run(jobs=[], trace=None)) is None
    spans([])
    assert read(run) is None


def test_kernel_sweep_share(spans):
    read = _reader("spline.kernel_sweep_pct").read
    run = traced_run()
    spans(call(0, 1, 3.0, ["cuda"] * 6) + call(1000, 20, 5.0, ["cuda"] * 6))
    assert read(run) == 100.0
    spans(call(0, 1, 3.0, ["cuda"] * 6) + call(1000, 20, 5.0,
                                               ["eager"] * 2))
    assert read(run) == 75.0
    # the parent commit's solves carry no path: None, not 0
    spans(call(0, 1, 3.0, [None] * 6) + call(1000, 20, 5.0, [None] * 6))
    assert read(run) is None
    assert read(harness.Run(jobs=[], trace=None)) is None


def test_readers_without_spans_in_the_program(monkeypatch):
    from neilpy_tpu_torch import profiling
    monkeypatch.delattr(profiling, "spans")
    run = traced_run()
    for name in NAMES:
        assert _reader(name).read(run) is None


def test_manifest_entries():
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    by_name = {m["name"]: m for m in man["per_layer"]}
    assert set(NAMES) <= set(by_name)
    new = [by_name[name] for name in NAMES]
    for m in new:
        assert m["layer"] == "spline coefficients"
        assert m["moves"] == "raster_mpix_s.host"
        assert m["workloads"] == [CELL]
        assert m["source"] == "program_span"
        assert (harness.BASE / "metrics" / f"{m['name']}.py").is_file()
    assert [m["unit"] for m in new] == ["ms", "%"]
    assert [m["better"] for m in new] == ["lower", "higher"]
