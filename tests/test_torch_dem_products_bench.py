"""The benchmark's DEM-products cell, ``dem_products.resident``, on the CPU
at a small size (263 x 257 with seeded NaN voids, radii (2, 5)).

- ``harness.run_cell``: ``correct``, every check beside its limit, the
  span metrics a CPU trace can read;
- the reference in bfloat16 (the control) and five faults put in the
  program's place (Gi in place of Gi*, the larger radius dropped, a
  square in place of its disk, the voids filled with 0 before the
  curvatures, the light at azimuth 316), each failing at least one
  limit;
- the float64 reference against the JAX package's ``hillshade``,
  ``esri_curvature`` and ``shi_landslides`` on the CPU, judged by the
  cell's own numbers and limits: the plain reference has the package's
  semantics, and the mask it judges is neither empty nor most of the
  raster;
- the job, its voids and its refusals; ``work()`` at 8192^2;
- the readers of the six per-layer metrics on hand-built records;
- ``BENCHMARK.json``: the entries that were there unchanged but for the
  cell appended to two metrics' lists.
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

import neilpy_tpu as nt
import neilpy_tpu_torch as ntt
from neilpy_tpu_torch import profiling

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
from portbench import control, harness, roofline  # noqa: E402
from portbench.reference import dem_products as reference  # noqa: E402
from portbench.systems import dem_products as system  # noqa: E402

torch.set_num_threads(1)
CELL = "dem_products.resident"
CFG = json.loads((REPO / "portbench/configs/dem_products.json").read_text())
LIMITS = CFG["limits"]
SHAPE = (263, 257)
SMALL = {"raster": list(SHAPE), "radii": [2, 5],
         "voids": {"share": 0.01, "radius": [2, 8]}}
TINY = {"config": SMALL, "traffic": {"sample_outputs": 3}}
SMALL_CFG = {**CFG, **SMALL}


def within(numbers):
    return all(v <= LIMITS[k] for k, v in numbers.items())


def cell(seed, traffic=None):
    return harness.prepare(CELL, seed, "cpu", overrides={
        "config": SMALL, "traffic": traffic or TINY["traffic"]})[3]


@pytest.fixture(scope="module")
def scene():
    """A DEM with voids, the port's outputs and the float64 reference."""
    dut = cell(2 ** 33 + 11)
    Z = dut.dems[0]
    got = dut._run(0, harness.spans(False))
    dut.close()
    return Z, got, reference.products(Z, SMALL_CFG)


def _run(tracing):
    return harness.run_cell(CELL, 2 ** 33 + 7, 0.3, tracing, "cpu", 0.0,
                            overrides=TINY, log=lambda *a, **k: None)


@pytest.mark.parametrize("tracing", [False, True])
def test_run_cell_is_correct_at_a_small_size(tracing):
    out = _run(tracing)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "checks"
    assert out["checks"] == {k: {"value": out["checks"][k]["value"],
                                 "limit": v} for k, v in LIMITS.items()}
    names = set(out["metrics"])
    if tracing:
        # what a CPU trace can read: no CUDA events, no kernels; the Gi*
        # spans say the plain torch version ran; the start-up metrics read
        # the once-spans this test process recorded before the window, if
        # any are left in its record
        startup = {"setup.import_s", "setup.library_s", "setup.first_use_s"}
        assert names - startup == {"dem_products.host_ms_per_job",
                                   "device.idle_pct.dem_products",
                                   "footprint.gi_kernel_pct"}
        assert all(out["metrics"][n]["value"] >= 0 for n in names & startup)
        assert out["metrics"]["dem_products.host_ms_per_job"]["value"] > 0
        assert out["metrics"]["footprint.gi_kernel_pct"]["value"] == 0.0
    else:
        assert names == {"raster_mpix_s", "job_p95_ms", "setup_s"}


FAULTS = {"gi_not_star": dict(star=False),
          "larger_radius_dropped": dict(radii=[2]),
          "square_for_the_disk": dict(square={5: 5}),
          "voids_filled_with_0": dict(void_fill=0.0),
          "azimuth_316": dict(azimuth=316.0)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_each_fault_in_the_programs_place_fails_a_limit(scene, fault):
    Z, _, want = scene
    out = reference.products(Z, SMALL_CFG, **FAULTS[fault])
    numbers = reference.differences(
        (out["hillshade"], out["curvature"], out["mask"]), want, Z,
        SMALL_CFG)
    assert not within(numbers), numbers


def test_the_control_is_not_correct_and_the_program_is():
    r = control.readings(CELL, 3, 0.2, "cpu", TINY)
    assert within(r["program"]) and r["program_failed"] == 0
    assert not within(r["control"])
    assert r["control_failed"] >= 1


def test_the_port_is_within_the_limits_and_its_mask_not_vacuous(scene):
    Z, got, want = scene
    numbers = reference.differences(got, want, Z, SMALL_CFG)
    assert set(numbers) == set(LIMITS) and within(numbers), numbers
    assert 0.1 <= reference.mask_share(want) <= 50


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 5])
def test_the_reference_judges_the_jax_package_within_the_limits(seed):
    """The JAX package's three products on the same DEM, judged as the
    program is: the plain reference has the package's semantics."""
    dut = cell(seed)
    Z = dut.dems[1]
    dut.close()
    z = Z.numpy()
    cs = SMALL_CFG["cellsize"]
    got = (torch.from_numpy(np.array(nt.hillshade(z, cs))),
           tuple(torch.from_numpy(np.array(c))
                 for c in nt.esri_curvature(z, cs)),
           torch.from_numpy(np.array(nt.shi_landslides(
               z, SMALL_CFG["radii"], cs))))
    want = reference.products(Z, SMALL_CFG)
    numbers = reference.differences(got, want, Z, SMALL_CFG)
    assert within(numbers), numbers
    assert 0.1 <= reference.mask_share(want) <= 50
    assert bool(torch.isnan(want["curvature"][0]).any())


@pytest.mark.parametrize("traffic", [{"placement": "host"},
                                     {"call": {"radii": [3]}}])
def test_the_cell_refuses_other_traffic(traffic):
    with pytest.raises(ValueError):
        harness.prepare(CELL, 1, "cpu", overrides={
            "config": SMALL, "traffic": traffic})


def test_a_job_is_the_three_products_of_one_dem_with_voids():
    dut = cell(5)
    try:
        assert dut.pixels_per_job == SHAPE[0] * SHAPE[1]
        assert len(dut.dems) == 4
        # bench_input's DEMs (geomorphons_l50's for the seed) with voids
        _, _, _, geo = harness.prepare("geomorphons_l50.resident", 5, "cpu",
                                       overrides={"config": SMALL})
        for a, b in zip(dut.dems, geo.dems):
            void = torch.isnan(a)
            assert 0.002 < float(void.float().mean()) < 0.05
            assert torch.equal(a[~void], b[~void])
        geo.close()
        for k in range(6):
            dut.job(k, harness.spans(False))
        assert len(dut.samples) == 3 and dut.seen == 6
        _, i, (shade, curv, mask) = dut.samples[0]
        Z = dut.dems[i]
        assert torch.equal(shade, ntt.hillshade(Z, 10.0, device="cpu"))
        for a, b in zip(curv, ntt.esri_curvature(Z, 10.0, device="cpu")):
            assert torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))
        assert torch.equal(mask, ntt.shi_landslides(Z, [2, 5], 10.0,
                                                    device="cpu"))
    finally:
        dut.close()


def test_voids_are_seeded_discs_near_their_share():
    a = system.voids(2, (512, 512), 9, 0.01, (4, 64), "cpu")
    assert torch.equal(a, system.voids(2, (512, 512), 9, 0.01, (4, 64),
                                       "cpu"))
    assert not torch.equal(a[0], a[1])
    assert not torch.equal(a, system.voids(2, (512, 512), 10, 0.01,
                                           (4, 64), "cpu"))
    big = system.voids(1, (2048, 2048), 3, 0.01, (4, 64), "cpu")
    assert 0.005 < float(big.float().mean()) < 0.015


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
            "import portbench.reference.dem_products; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'neilpy_tpu', 'neilpy_tpu_torch'}))"
            % str(REPO))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert res.stdout.strip() == "[]"


def test_the_work_of_a_job_at_8192():
    """349 operations and 26 bytes a pixel: bound by operations, 0.699 ms
    a job."""
    work = system.dem_work(8192, 8192, (5, 13))
    assert work == {"ops": 349 * 8192 * 8192, "bytes": 26 * 8192 * 8192}
    least, side = roofline.bound_seconds(work["ops"], work["bytes"])
    assert side == "operations"
    assert least * 1e3 == pytest.approx(0.6991, abs=1e-4)
    dut = cell(1)
    try:
        assert dut.work() == system.dem_work(*SHAPE, (2, 5))
    finally:
        dut.close()


# ----------------------------------------------------------------------
# the readers of the six per-layer metrics
# ----------------------------------------------------------------------
MS = 1_000_000


def fake(name, t0, t1, sid, parent=None, root=None, device_ms=None):
    return types.SimpleNamespace(name=name, start_ns=t0, end_ns=t1, id=sid,
                                 parent=parent, root=root or sid,
                                 device_ms=device_ms, attr=None,
                                 thread="MainThread")


def job_spans(t, first):
    """One job's spans from ``t`` ms: hillshade 1 ms of host (device 8),
    ESRI 2 ms (24), shi_landslides 3 ms with Evans (40) and two Gi*
    (25, 60)."""
    i = first
    return [fake("surface.hillshade", t * MS, (t + 1) * MS, i, None, None,
                 8.0),
            fake("surface.esri_curvature", (t + 1) * MS, (t + 3) * MS,
                 i + 1, None, None, 24.0),
            fake("stats.shi_landslides", (t + 3) * MS, (t + 6) * MS, i + 2),
            fake("surface.evans_curvature", (t + 3) * MS, (t + 4) * MS,
                 i + 3, i + 2, i + 2, 40.0),
            fake("stats.rasterGi", (t + 4) * MS, (t + 5) * MS, i + 4, i + 2,
                 i + 2, 25.0),
            fake("stats.rasterGi", (t + 5) * MS, (t + 6) * MS, i + 5, i + 2,
                 i + 2, 60.0)]


# two jobs in the window, one outside it
SPANS = job_spans(0, 1) + job_spans(10, 11) + job_spans(500, 21)
JOBS = [(0, 7 * MS), (10 * MS, 17 * MS)]
READERS = {"dem_products.gi_ms_per_job": 85.0,
           "dem_products.curvature_ms_per_job": 64.0,
           "dem_products.host_ms_per_job": 6.0}


def reader(name):
    return harness.load_module(harness.BASE / "metrics" / f"{name}.py",
                               f"portbench.metrics.{name}")


@pytest.mark.parametrize("name", sorted(READERS))
def test_span_readers(monkeypatch, name):
    read = reader(name).read
    trace = types.SimpleNamespace(window=(0, 100 * MS), jobs=JOBS)
    run = harness.Run(jobs=[], trace=trace)
    monkeypatch.setattr(profiling, "spans", lambda: list(SPANS))
    assert read(run) == pytest.approx(READERS[name])
    assert read(harness.Run(jobs=[], trace=None)) is None
    # a program without these spans (the parent commit) reads None
    monkeypatch.setattr(profiling, "spans", lambda: [
        fake("visibility.geomorphons", 0, MS, 1)])
    assert read(run) is None
    monkeypatch.delattr(profiling, "spans")
    assert read(run) is None


def test_trace_readers():
    work = system.dem_work(8192, 8192, (5, 13))
    least, _ = roofline.bound_seconds(work["ops"], work["bytes"])
    # two jobs of 160 and 170 device-busy ms; kernels and a copy
    device = [("kernelA", 1, 2), ("Memcpy HtoD", 3, 4), ("kernelB", 5, 6),
              ("Memset", 12, 13), ("kernelC", 14, 15), ("kernelD", 30, 31)]
    trace = types.SimpleNamespace(jobs=[(0, 10), (10, 20)], device=device,
                                  busy_per_job=lambda: [0.160, 0.170],
                                  idle_pct=lambda: 4.5)
    run = harness.Run(jobs=[], trace=trace, work=work)
    assert reader("dem_products_roofline").read(run) == pytest.approx(
        100.0 * 2 * least / 0.330)
    assert reader("device.idle_pct.dem_products").read(run) == 4.5
    assert reader("dem_products.launches_per_job").read(run) == 1.5
    trace.busy_per_job = lambda: [0.0, 0.0]
    trace.device = [("Memcpy HtoD", 3, 4)]
    assert reader("dem_products_roofline").read(run) is None
    assert reader("dem_products.launches_per_job").read(run) is None
    for name in ("dem_products_roofline", "device.idle_pct.dem_products",
                 "dem_products.launches_per_job"):
        assert reader(name).read(harness.Run(jobs=[], trace=None,
                                             work=work)) is None


# ----------------------------------------------------------------------
# the manifest
# ----------------------------------------------------------------------
MAN = json.loads((REPO / "BENCHMARK.json").read_text())
# sha256 (first 16 hex digits) of each list as the parent commit had it,
# ``json.dumps(..., sort_keys=True)``
BEFORE = {"configs": (4, "0092d3f484abdaa5"),
          "workloads": (6, "576154c98f8247e2"),
          "end_to_end": (6, "e1c1bffbb4274141"),
          "per_layer": (28, "775db12d96628b8c")}
NEW_METRICS = ["dem_products_roofline", "device.idle_pct.dem_products",
               "dem_products.launches_per_job", "dem_products.gi_ms_per_job",
               "dem_products.curvature_ms_per_job",
               "dem_products.host_ms_per_job"]


def _digest(x):
    return hashlib.sha256(json.dumps(x, sort_keys=True).encode()) \
        .hexdigest()[:16]


@pytest.mark.parametrize("kind", sorted(BEFORE))
def test_entries_that_were_there_are_unchanged_but_two_appended_names(kind):
    n, digest = BEFORE[kind]
    old = json.loads(json.dumps(MAN[kind][:n]))
    # cells added after this one may be appended to a metric's list
    later = {w["name"] for w in MAN["workloads"][7:]}
    for m in old:
        if "workloads" in m:
            m["workloads"] = [w for w in m["workloads"] if w not in later]
        if m["name"] in ("raster_mpix_s", "job_p95_ms"):
            assert m["workloads"][-1] == CELL
            m["workloads"].pop()
    assert _digest(old) == digest


def test_the_new_entries():
    (cfg,) = MAN["configs"][4:5]
    assert cfg["name"] == "dem_products" and cfg["reduced"] == ["raster"]
    assert cfg["file"] == "portbench/configs/dem_products.json"
    assert cfg["source"] == CFG["source"] and len(cfg["source"]) <= 200
    (w,) = MAN["workloads"][6:7]
    assert (w["name"], w["config"], w["traffic"], w["chips"]) \
        == (CELL, "dem_products", "resident", 1)
    new = MAN["per_layer"][28:34]
    assert [m["name"] for m in new] == NEW_METRICS
    for m in new:
        assert m["workloads"] == [CELL] and m["moves"] == "raster_mpix_s"
    assert [m["layer"] for m in new] == [
        "kernels", "device", "kernel launch", "footprint statistics",
        "surface stencils", "API"]
    spec = harness.CellSpec(CELL)
    assert {m["name"] for m in spec.metrics("end_to_end")} == {
        "raster_mpix_s", "job_p95_ms", "setup_s"}
    # the cell's own metrics, the one a later PR appended to it and the
    # start-up ones appended to every cell
    assert [m["name"] for m in spec.metrics("per_layer")] == \
        NEW_METRICS + ["footprint.gi_kernel_pct", "setup.import_s",
                       "setup.library_s", "setup.first_use_s"]


def test_the_configuration_and_its_traffic():
    assert (CFG["raster"], CFG["dtype"], CFG["cellsize"], CFG["radii"]) \
        == ([8192, 8192], "float32", 10.0, [5, 13])
    assert CFG["voids"] == {"share": 0.01, "radius": [4, 64]}
    traffic = json.loads((REPO / "portbench/traffic/resident.json")
                         .read_text())
    assert traffic == {"placement": "device", "inputs": 4, "call": {},
                       "sample_outputs": 8}
    assert set(CFG["limits_why"]) == set(LIMITS) | {"ties"}
    assert LIMITS["hillshade_off_tie_px"] == LIMITS["landslide_off_tie_px"] \
        == LIMITS["nan_mismatch_px"] == 0
