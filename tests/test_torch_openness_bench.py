"""The benchmark's openness cell, ``openness_l50.resident``, on the CPU at
small sizes.

- the port's ``openness_pair`` and ``skyview_factor`` against the plain
  float64 reference (``portbench/reference/openness_l50.py``) on seeded
  ``bench_input`` DEMs at lookups 8 and 50 (50 exceeds half the raster,
  so the off-raster rule engages) and on a DEM with NaN holes, within the
  cell's limits;
- the reference in bfloat16 (the control) and float16, the fast ladder,
  the ladder cut to 1..49, seven directions and SVF without its clip at
  0, each put in the program's place and failing at least one limit;
- the reference against the numpy oracles ``np_openness`` and
  ``np_skyview_factor`` to float64 rounding on NaN-free DEMs;
- ``harness.run_cell`` on a tiny raster: ``correct``, every check beside
  its limit, the span metrics of a traced run; no JAX loaded;
- ``work()``'s bound at 8192^2 and lookup 50;
- the readers of its per-layer metrics on hand-built records;
- ``BENCHMARK.json``: the new entries, and the two appended cell names
  the only change to an entry that was there.

No JAX is imported here.
"""

import hashlib
import json
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import neilpy_tpu_torch as ntt
from neilpy_tpu_torch import profiling

from .reference_impls import np_openness, np_skyview_factor

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
from portbench import control, harness, inputs, roofline  # noqa: E402
from portbench.reference import openness_l50 as reference  # noqa: E402
from portbench.reference.plain import scan_ladder  # noqa: E402
from portbench.systems import openness_l50 as system  # noqa: E402

torch.set_num_threads(1)
CELL = "openness_l50.resident"
CFG = json.loads((REPO / "portbench/configs/openness_l50.json").read_text())
LIMITS = CFG["limits"]
SHAPE = (96, 128)
TINY = {"config": {"raster": list(SHAPE)}, "traffic": {"sample_outputs": 3}}


def dem(seed, shape=SHAPE):
    return inputs.bench_input(1, shape, seed, "cpu")[0]


def holed(seed):
    """A DEM with NaN holes: a block, a row stub, single pixels, a
    corner."""
    Z = dem(seed).clone()
    Z[30:41, 50:70] = float("nan")
    Z[5, :9] = float("nan")
    Z[60, 100] = Z[80, 3] = float("nan")
    Z[-4:, -4:] = float("nan")
    return Z


def port(Z, lookup_pixels=CFG["lookup_pixels"]):
    """The timed calls at the cell's cellsize: (pos, neg, svf)."""
    kw = dict(cellsize=CFG["cellsize"], lookup_pixels=lookup_pixels,
              device="cpu")
    return (*ntt.openness_pair(Z, **kw), ntt.skyview_factor(Z, **kw))


def at(lookup_pixels):
    return {**CFG, "lookup_pixels": lookup_pixels}


def within(got):
    return all(v <= LIMITS[k] for k, v in got.items())


@pytest.mark.parametrize("seed, lookup_pixels, holes", [
    (1, 8, False), (2 ** 33 + 5, 8, False),
    (1, 50, False), (2 ** 33 + 5, 50, False),
    (7, 8, True), (7, 50, True)])
def test_the_port_is_within_the_limits_of_the_reference(seed, lookup_pixels,
                                                        holes):
    Z = holed(seed) if holes else dem(seed)
    want = reference.relief(Z, at(lookup_pixels))
    got = reference.differences(port(Z, lookup_pixels), want)
    assert set(got) == set(LIMITS)
    assert within(got), got
    if holes:
        # a hole's pixels see nothing: +inf openness on both sides
        assert not torch.isfinite(want[0][35, 60])
        assert bool(torch.isfinite(want[0][0, 0]))


FAULTS = {"bfloat16": dict(dtype=torch.bfloat16),
          "float16": dict(dtype=torch.float16),
          "fast_ladder": dict(ladder=scan_ladder(50, True, 20)),
          "ladder_1_49": dict(ladder=tuple(range(1, 50))),
          "seven_directions": dict(directions=tuple(range(7))),
          "svf_unclipped": dict(clip=False)}


@pytest.fixture(scope="module")
def scene():
    Z = dem(11)
    return Z, reference.relief(Z, CFG)


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_each_fault_fails_a_limit(scene, fault):
    Z, want = scene
    got = reference.differences(reference.relief(Z, CFG, **FAULTS[fault]),
                                want)
    assert not within(got), got


def test_the_control_is_not_correct_and_the_program_is():
    r = control.readings(CELL, 3, 0.2, "cpu", TINY)
    assert within(r["program"]) and r["program_failed"] == 0
    assert not within(r["control"])
    assert r["control_failed"] >= 1


@pytest.mark.parametrize("seed, lookup_pixels", [(3, 8), (4, 50)])
def test_the_reference_is_the_numpy_oracles(seed, lookup_pixels):
    Z = dem(seed, (40, 56))
    pos, neg, svf = reference.relief(Z, at(lookup_pixels))
    z = Z.double().numpy()
    kw = dict(cellsize=CFG["cellsize"], lookup_pixels=lookup_pixels)
    # float64 rounding: the same ratios, atan and mean in another order
    np.testing.assert_allclose(pos.numpy(), np_openness(z, **kw),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(neg.numpy(), np_openness(-z, **kw),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(svf.numpy(), np_skyview_factor(z, **kw),
                               rtol=0, atol=1e-13)


def _run(tracing):
    return harness.run_cell(CELL, 2 ** 33 + 7, 0.2, tracing, "cpu", 0.0,
                            overrides=TINY, log=lambda *a, **k: None)


@pytest.mark.parametrize("tracing", [False, True])
def test_run_cell_is_correct_on_a_tiny_raster(tracing):
    out = _run(tracing)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "checks"
    assert out["checks"] == {k: {"value": out["checks"][k]["value"],
                                 "limit": v} for k, v in LIMITS.items()}
    names = set(out["metrics"])
    if tracing:
        # the span metrics a CPU run can read (no CUDA events, no kernels)
        assert {"openness.host_ms_per_call",
                "device.idle_pct.openness"} <= names
        assert out["metrics"]["openness.host_ms_per_call"]["value"] > 0
        assert "openness.ladder_ms_per_call" not in names
    else:
        assert names == {"raster_mpix_s", "job_p95_ms", "setup_s"}


@pytest.mark.parametrize("traffic", [{"placement": "host"},
                                     {"call": {"fast": True}}])
def test_the_cell_refuses_other_traffic(traffic):
    with pytest.raises(ValueError):
        harness.prepare(CELL, 1, "cpu", overrides={
            "config": TINY["config"], "traffic": traffic})


def test_a_job_is_the_pair_and_the_sky_view_factor_of_one_dem():
    cell, config, traffic, dut = harness.prepare(CELL, 5, "cpu",
                                                 overrides=TINY)
    try:
        assert dut.pixels_per_job == SHAPE[0] * SHAPE[1]
        assert len(dut.dems) == 4
        # the same DEMs as geomorphons_l50 for the same seed
        _, _, _, geo = harness.prepare("geomorphons_l50.resident", 5, "cpu",
                                       overrides={"config": TINY["config"]})
        assert all(torch.equal(a, b) for a, b in zip(dut.dems, geo.dems))
        geo.close()
        for k in range(6):
            dut.job(k, harness.spans(False))
        assert len(dut.samples) == 3 and dut.seen == 6
        k, i, got = dut.samples[0]
        for a, b in zip(got, port(dut.dems[i])):
            assert torch.equal(a, b)
    finally:
        dut.close()


def test_a_cell_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys; sys.path.insert(0, %r); "
            "from portbench import harness; "
            "harness.run_cell(%r, 5, 0.1, False, 'cpu', 0.0, "
            "overrides=%r, log=lambda *a, **k: None); "
            "print(harness.banned_modules())" % (str(REPO), CELL, TINY))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_imports_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, %r); "
            "import portbench.reference.openness_l50; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'neilpy_tpu', 'neilpy_tpu_torch'}))"
            % str(REPO))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert res.stdout.strip() == "[]"


def test_the_work_of_a_job_bounds_it_at_the_kernel_tables_sum():
    """PERF.md's kernel table: K5/reduced openness 4.09 ms and svf 2.47
    ms with the fold, both by operations, at 8192^2 and lookup 50."""
    work = system.relief_work(8192, 8192, 50)
    least, side = roofline.bound_seconds(work["ops"], work["bytes"])
    assert side == "operations"
    assert least * 1e3 == pytest.approx(6.56, abs=0.01)
    assert work["bytes"] == 20 * 8192 * 8192
    _, _, _, dut = harness.prepare(CELL, 1, "cpu", overrides=TINY)
    try:
        assert dut.work() == system.relief_work(*SHAPE, 50)
    finally:
        dut.close()


# ----------------------------------------------------------------------
# the readers of the four per-layer metrics
# ----------------------------------------------------------------------
MS = 1_000_000


def fake(name, t0, t1, sid, parent=None, root=None, device_ms=None,
         attr=None):
    return types.SimpleNamespace(name=name, start_ns=t0, end_ns=t1, id=sid,
                                 parent=parent, root=root or sid,
                                 device_ms=device_ms, attr=attr,
                                 thread="MainThread")


# one job: a pair of 2 ms of host with its launch 6.2 device ms, a sky-view
# factor of 1 ms with 5.4; a launch of a geomorphons call (not read), and
# a pair outside the window
SPANS = [fake("visibility.openness_pair", 0, 2 * MS, 1, attr="plan"),
         fake("visibility.as_raster", 0, MS // 10, 2, 1, 1),
         fake("cuda_scan.launch", MS // 10, MS, 3, 1, 1, 6.2,
              "openness_reduced_plan_launch"),
         fake("visibility.skyview_factor", 3 * MS, 4 * MS, 4, attr="plan"),
         fake("cuda_scan.launch", 3 * MS, 3 * MS + MS // 2, 5, 4, 4, 5.4,
              "openness_reduced_plan_launch"),
         fake("visibility.geomorphons", 5 * MS, 6 * MS, 6),
         fake("cuda_scan.launch", 5 * MS, 6 * MS, 7, 6, 6, 9.0),
         fake("visibility.openness_pair", 200 * MS, 201 * MS, 8)]
READERS = {"openness.ladder_ms_per_call": 5.8,
           "openness.host_ms_per_call": 1.5}


def reader(name):
    return harness.load_module(harness.BASE / "metrics" / f"{name}.py",
                               f"portbench.metrics.{name}")


@pytest.mark.parametrize("name", sorted(READERS))
def test_span_readers(monkeypatch, name):
    read = reader(name).read
    trace = types.SimpleNamespace(window=(0, 100 * MS), busy=[])
    run = harness.Run(jobs=[], trace=trace)
    monkeypatch.setattr(profiling, "spans", lambda: list(SPANS))
    assert read(run) == pytest.approx(READERS[name])
    assert read(harness.Run(jobs=[], trace=None)) is None
    # a program without these spans (the parent commit) reads None
    monkeypatch.setattr(profiling, "spans", lambda: SPANS[5:7])
    assert read(run) is None
    monkeypatch.delattr(profiling, "spans")
    assert read(run) is None


def test_roofline_and_idle_readers():
    # two jobs of 13 and 12 device-busy ms; the bound of one job's work
    work = system.relief_work(8192, 8192, 50)
    least, _ = roofline.bound_seconds(work["ops"], work["bytes"])
    trace = types.SimpleNamespace(jobs=[(0, 20), (20, 40)],
                                  busy_per_job=lambda: [0.013, 0.012],
                                  idle_pct=lambda: 4.5)
    run = harness.Run(jobs=[], trace=trace, work=work)
    assert reader("openness_roofline").read(run) == pytest.approx(
        100.0 * 2 * least / 0.025)
    assert reader("device.idle_pct.openness").read(run) == 4.5
    trace.busy_per_job = lambda: [0.0, 0.0]
    assert reader("openness_roofline").read(run) is None
    for name in ("openness_roofline", "device.idle_pct.openness"):
        assert reader(name).read(harness.Run(jobs=[], trace=None,
                                             work=work)) is None


# ----------------------------------------------------------------------
# the manifest
# ----------------------------------------------------------------------
MAN = json.loads((REPO / "BENCHMARK.json").read_text())
# sha256 (first 16 hex digits) of each list as the parent commit had it,
# ``json.dumps(..., sort_keys=True)``
BEFORE = {"configs": (3, "21724cf4d489db80"),
          "workloads": (5, "19df34f74967f7d5"),
          "end_to_end": (6, "2cea9b252fae779e"),
          "per_layer": (23, "e8a33353e7a63a7e")}
NEW_METRICS = ["openness_roofline", "openness.ladder_ms_per_call",
               "openness.host_ms_per_call", "device.idle_pct.openness"]
STARTUP_METRICS = ["setup.import_s", "setup.library_s", "setup.first_use_s"]


def _digest(x):
    return hashlib.sha256(json.dumps(x, sort_keys=True).encode()) \
        .hexdigest()[:16]


@pytest.mark.parametrize("kind", sorted(BEFORE))
def test_entries_that_were_there_are_unchanged_but_two_appended_names(kind):
    n, digest = BEFORE[kind]
    old = json.loads(json.dumps(MAN[kind][:n]))
    # cells added after this one may be appended to a metric's list
    later = {w["name"] for w in MAN["workloads"][6:]}
    for m in old:
        if "workloads" in m:
            m["workloads"] = [w for w in m["workloads"] if w not in later]
        if m["name"] in ("raster_mpix_s", "job_p95_ms"):
            assert m["workloads"][-1] == CELL
            m["workloads"].pop()
    assert _digest(old) == digest


def test_the_new_entries():
    (cfg,) = MAN["configs"][3:4]
    assert cfg["name"] == "openness_l50" and cfg["reduced"] == ["raster"]
    assert cfg["file"] == "portbench/configs/openness_l50.json"
    assert cfg["source"] == CFG["source"] and len(cfg["source"]) <= 200
    (cell,) = MAN["workloads"][5:6]
    assert (cell["name"], cell["config"], cell["traffic"], cell["chips"]) \
        == (CELL, "openness_l50", "resident", 1)
    new = MAN["per_layer"][23:27]
    assert [m["name"] for m in new] == NEW_METRICS
    for m in new:
        assert m["workloads"] == [CELL]
        assert m["moves"] == "raster_mpix_s"
        assert (harness.BASE / "metrics" / f"{m['name']}.py").is_file()
    assert [m["layer"] for m in new] == ["kernels", "kernels", "API",
                                        "device"]
    spec = harness.CellSpec(CELL)
    assert {m["name"] for m in spec.metrics("end_to_end")} == {
        "raster_mpix_s", "job_p95_ms", "setup_s"}
    # the cell's own metrics, and the start-up ones a later PR appended to
    # every cell
    assert [m["name"] for m in spec.metrics("per_layer")] == \
        NEW_METRICS + STARTUP_METRICS


def test_the_configuration_and_its_traffic():
    assert (CFG["raster"], CFG["dtype"], CFG["cellsize"],
            CFG["lookup_pixels"], CFG["directions"], CFG["fast"]) \
        == ([8192, 8192], "float32", 10.0, 50, 8, False)
    traffic = json.loads((REPO / "portbench/traffic/resident.json")
                         .read_text())
    assert traffic == {"placement": "device", "inputs": 4, "call": {},
                       "sample_outputs": 8}
    assert set(CFG["limits_why"]) == set(LIMITS) == {
        "openness_max_abs_deg", "svf_max_abs", "unseen_mismatch_px"}
    assert LIMITS["unseen_mismatch_px"] == 0
