"""The reader of the springs fill's ``inpaint.kcycle_kernel_pct`` on
hand-built span records, and its manifest entry."""

import json
import types

import pytest

from portbench import harness

from .conftest import ROOT

MS = 1_000_000
NAME = "inpaint.kcycle_kernel_pct"


def _read(run):
    return harness.load_module(harness.BASE / "metrics" / f"{NAME}.py",
                               "t_kcycle").read(run)


def span(name, t0, t1, sid, parent=None, root=None, attr=None):
    return types.SimpleNamespace(name=name, start_ns=t0, end_ns=t1, id=sid,
                                 parent=parent, root=root or sid,
                                 device_ms=1.0, attr=attr,
                                 thread="MainThread")


def call(base, sid, kcycles):
    """One ``smrf.call`` of 1 s from ``base`` ms with one
    ``inpaint.springs`` span an entry of ``kcycles`` (a value of the
    ``kcycle`` attr, or ``...`` for a fill whose attr lacks the key)."""
    t = base * MS
    out = [span("smrf.call", t, t + 1000 * MS, sid)]
    for k, how in enumerate(kcycles):
        attr = {"iterations": 5, "graph": "replayed"}
        if how is not ...:
            attr["kcycle"] = how
        out.append(span("inpaint.springs", t + (100 + k) * MS,
                        t + (101 + k) * MS, sid + 1 + k, sid, sid, attr))
    return out


@pytest.fixture
def spans(monkeypatch):
    from neilpy_tpu_torch import profiling

    def use(record):
        monkeypatch.setattr(profiling, "spans", lambda: list(record))
    return use


def traced_run():
    trace = types.SimpleNamespace(window=(0, 2000 * MS), busy=[])
    return harness.Run(jobs=[], trace=trace)


@pytest.mark.parametrize("first,second,want", [
    (["cuda", "cuda"], ["cuda", "cuda"], 100.0),
    (["torch", "torch"], ["torch", "torch"], 0.0),
    (["cuda", "cuda"], ["cuda", "torch"], 75.0),
    # a Jacobi fill runs no K-cycle: it counts for neither side
    (["cuda", None], ["cuda", "cuda"], 100.0),
    # the parent commit's fills carry no kcycle: None, not 0
    ([..., ...], [..., ...], None),
    ([None], [None], None)])
def test_kcycle_kernel_share(spans, first, second, want):
    run = traced_run()
    # a third call outside the window counts for nothing
    spans(call(0, 1, first) + call(1000, 20, second)
          + call(3000, 40, ["torch"] * 4))
    assert _read(run) == want
    assert _read(harness.Run(jobs=[], trace=None)) is None


def test_reader_without_spans_in_the_program(monkeypatch):
    from neilpy_tpu_torch import profiling
    monkeypatch.delattr(profiling, "spans")
    assert _read(traced_run()) is None


def test_manifest_entry():
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    m = {m["name"]: m for m in man["per_layer"]}[NAME]
    assert m == {"name": NAME, "unit": "%", "better": "higher",
                 "source": "program_span", "layer": "springs fill",
                 "moves": "raster_mpix_s.host",
                 "workloads": ["smrf_isprs.tile5m"]}
    assert man["per_layer"][-1]["name"] == NAME
