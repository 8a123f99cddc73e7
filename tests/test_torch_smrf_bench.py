"""The benchmark's SMRF cell, ``smrf_isprs.tile5m``, on the CPU at small
sizes, and the spans one ``smrf`` call records.

- the port's ``smrf`` against the plain float64 reference
  (``portbench/reference/smrf_isprs.py``) on seeded ``lidar_tile``
  clouds, windows 18, within the cell's limits;
- the reference's raster stage in bfloat16 (the control), fewer windows
  (6: most of the 10-24 m buildings stay unopened), a CG capped at one
  iteration or stopped at a loose tolerance, and a skipped low-outlier
  pass, each failing at least one of the limits;
- ``harness.run_cell`` on a tiny cloud: ``correct``, every check beside
  its limit, the span metrics of a traced run; no JAX loaded;
- the span tree of a call under a profile (names, parents, each fill's
  ``iterations`` equal to what the fill reports) and none without one;
- the readers of its per-layer metrics on hand-built records;
- ``BENCHMARK.json``: the new entries, and the two appended cell names
  the only change to an entry that was there.

No JAX is imported here.
"""

import hashlib
import importlib
import inspect
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
from neilpy_tpu_torch.ops.spline import spline_coefficients_2d, spline_ev_2d

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
from portbench import harness  # noqa: E402
from portbench.reference import smrf_isprs as reference  # noqa: E402
from portbench.systems import smrf_isprs as system  # noqa: E402

torch.set_num_threads(1)
smrf_mod = importlib.import_module("neilpy_tpu_torch.pipelines.smrf")
CELL = "smrf_isprs.tile5m"
CFG = json.loads((REPO / "portbench/configs/smrf_isprs.json").read_text())
LIMITS = CFG["limits"]
TINY = {"config": {"points": 12_000, "extent": 100.0},
        "traffic": {"inputs": 2}}


def cloud(seed, n=30_000, side=160.0):
    return system.lidar_tile(np.random.default_rng(seed), n, side)


def port(x, y, z, windows=CFG["windows"], **kw):
    """The timed call at the cell's parameters: (labels, dtm) as numpy."""
    dtm, _, _, labels = ntt.smrf(
        x, y, z, cellsize=CFG["cellsize"], windows=windows,
        slope_threshold=CFG["slope_threshold"],
        elevation_threshold=CFG["elevation_threshold"],
        elevation_scaler=CFG["elevation_scaler"], device="cpu", **kw)
    return labels.numpy(), dtm.numpy()


def checks(labels, dtm, want):
    return system.compare(labels, dtm, want, "cpu", CFG["dtm_tolerance_m"])


def within(got):
    return all(v <= LIMITS[k] for k, v in got.items())


@pytest.fixture(scope="module")
def scene():
    """A 30,000-point cloud over 160 m and its reference answer."""
    x, y, z = cloud(11)
    return (x, y, z), reference.smrf(x, y, z, CFG, "cpu")


@pytest.mark.parametrize("seed, n, side", [(11, 30_000, 160.0),
                                           (12, 50_000, 200.0),
                                           (2 ** 33 + 5, 20_000, 130.0)])
def test_the_port_is_within_the_limits_of_the_reference(seed, n, side):
    x, y, z = cloud(seed, n, side)
    want = reference.smrf(x, y, z, CFG, "cpu")
    got = checks(*port(x, y, z), want)
    assert set(got) == set(LIMITS)
    assert within(got), got
    # the exact path is the reference's own arithmetic
    labels, dtm = port(x, y, z, precision="exact")
    assert checks(labels, dtm, want)["label_diff_ppm"] == 0
    assert np.abs(dtm - want["dtm"].numpy()).max() < 1e-6


def _capped(real, maxiter=None, tol=None):
    def fill(A, t, m, multiscale=True):
        return real(A, tol or t, maxiter or m, multiscale)
    return fill


@pytest.mark.parametrize("fault", ["bfloat16", "windows6", "cg_one_iteration",
                                   "cg_loose_tolerance", "no_low_outliers"])
def test_each_fault_fails_a_limit(scene, monkeypatch, fault):
    (x, y, z), want = scene
    if fault == "bfloat16":
        low = reference.smrf(x, y, z, CFG, "cpu", torch.bfloat16)
        labels, dtm = low["labels"].numpy(), low["dtm"].float().numpy()
    elif fault == "windows6":
        labels, dtm = port(x, y, z, windows=6)
    elif fault == "no_low_outliers":
        labels, dtm = port(x, y, z, low_filter_slope=1e9)
    else:
        real = smrf_mod._springs_core
        monkeypatch.setattr(smrf_mod, "_springs_core", _capped(
            real, maxiter=1 if fault == "cg_one_iteration" else None,
            tol=1e-2 if fault == "cg_loose_tolerance" else None))
        labels, dtm = port(x, y, z)
    assert not within(checks(labels, dtm, want))


@pytest.mark.parametrize("fault", ["dropped", "reordered", "shifted_dtm"])
def test_lost_or_moved_outputs_fail(scene, fault):
    (x, y, z), want = scene
    labels, dtm = port(x, y, z)
    if fault == "dropped":
        labels = labels[:-1]
    elif fault == "reordered":
        labels = labels[::-1].copy()
    else:
        dtm = dtm[1:]
    got = checks(labels, dtm, want)
    assert not within(got)
    assert (got["label_count_diff"] > 0) == (fault != "reordered")


def _run(tracing):
    return harness.run_cell(CELL, 2 ** 33 + 7, 0.2, tracing, "cpu", 0.0,
                            overrides=TINY, log=lambda *a, **k: None)


@pytest.mark.parametrize("tracing", [False, True])
def test_run_cell_is_correct_on_a_tiny_cloud(tracing):
    out = _run(tracing)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "checks"
    assert out["checks"] == {k: {"value": out["checks"][k]["value"],
                                 "limit": v} for k, v in LIMITS.items()}
    names = set(out["metrics"])
    if tracing:
        # the span metrics a CPU run can read (no CUDA events, no kernels)
        assert {"device.idle_pct.smrf", "inpaint.cg_iters_per_fill",
                "smrf.host_pct"} <= names
        assert "smrf.launches_per_job" not in names
        assert out["metrics"]["inpaint.cg_iters_per_fill"]["value"] >= 1
    else:
        assert names == {"raster_mpix_s.host", "job_p95_ms.host",
                         "setup_s"}


def test_the_control_is_not_correct_and_the_program_is():
    from portbench import control
    r = control.readings(CELL, 3, 0.2, "cpu", TINY)
    assert all(v <= LIMITS[k] for k, v in r["program"].items())
    assert any(v > LIMITS[k] for k, v in r["control"].items())
    assert r["control_failed"] >= 1


def test_pixels_per_job_are_the_grids_cells():
    cell, config, traffic, dut = harness.prepare(CELL, 5, "cpu",
                                                 overrides=TINY)
    try:
        dut.warm(harness.spans(False))
        x, y, _ = dut.clouds[0]
        ny, nx, _, _ = reference.grid_frame(x, y, config["cellsize"])
        assert dut.pixels_per_job == ny * nx
        assert len(dut.clouds) == 2 and x.dtype == np.float64
    finally:
        dut.close()


def test_a_cell_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys; sys.path.insert(0, %r); "
            "from portbench import harness; "
            "harness.run_cell(%r, 5, 0.1, False, 'cpu', 0.0, "
            "overrides=%r, log=lambda *a, **k: None); "
            "import portbench.reference.smrf_isprs; "
            "print(harness.banned_modules())" % (str(REPO), CELL, TINY))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_imports_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, %r); "
            "import portbench.reference.smrf_isprs; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'neilpy_tpu', 'neilpy_tpu_torch'}))"
            % str(REPO))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert res.stdout.strip() == "[]"


def test_the_reference_spline_interpolates_and_is_not_a_knot():
    rng = np.random.default_rng(0)
    Z = torch.from_numpy(rng.normal(size=(9, 7)).cumsum(0))
    spline = reference.spline_of(Z)
    r, c = torch.meshgrid(torch.arange(9.0) + 0.5, torch.arange(7.0) + 0.5,
                          indexing="ij")
    at = reference.spline_at(spline, r.reshape(-1), c.reshape(-1))
    np.testing.assert_allclose(at.numpy(), Z.reshape(-1).numpy(),
                               atol=1e-12)
    # the port's spline at scattered points, from its own moments
    rq = torch.from_numpy(rng.uniform(-1, 10, 50))
    cq = torch.from_numpy(rng.uniform(-1, 8, 50))
    want = spline_ev_2d(spline_coefficients_2d(Z, device="cpu"), rq, cq,
                        offset=0.5)
    np.testing.assert_allclose(reference.spline_at(spline, rq, cq).numpy(),
                               want.numpy(), atol=1e-10)


def test_the_reference_fill_is_the_springs_rest_state():
    Z = torch.from_numpy(np.random.default_rng(1).normal(size=(30, 40))
                         .cumsum(1))
    A = Z.clone()
    A[5:15, 8:20] = float("nan")
    A[0, :3] = float("nan")
    filled, _ = reference.springs_fill(A)
    want = ntt.inpaint_nans_by_springs(A, tol=1e-13, maxiter=10_000,
                                       device="cpu")
    np.testing.assert_allclose(filled.numpy(), want.numpy(), atol=1e-8)


# ----------------------------------------------------------------------
# spans
# ----------------------------------------------------------------------
def _profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


CHILDREN = {"smrf.gridding", "inpaint.springs", "smrf.low_outliers",
            "smrf.ladder", "smrf.spline", "smrf.inverse_affine",
            "smrf.points"}


def test_one_call_records_its_span_tree():
    x, y, z = cloud(21, 15_000, 110.0)
    fills = []
    kw = dict(cellsize=1, windows=18, slope_threshold=.15,
              elevation_threshold=.5, elevation_scaler=1.25,
              low_filter_slope=5, low_outlier_fill=False,
              return_extras=False, precision="fast",
              chunk_points=2_000_000, device="cpu")
    with _profile():
        pass
    profiling.clear_spans()
    with _profile():
        dtm, _, _, labels = smrf_mod._smrf_run(
            x, y, z, mark=lambda stage, **info: info and fills.append(info),
            **kw)
    spans = profiling.spans()
    by_id = {s.id: s for s in spans}
    (call,) = [s for s in spans if s.name == "smrf.call"]
    assert call.parent is None and call.attr == {
        "precision": "fast", "points": 15_000, "grid": list(dtm.shape)}
    kids = [s for s in spans if s.parent == call.id]
    assert {s.name for s in kids} == CHILDREN
    assert [s.name for s in sorted(kids, key=lambda s: s.start_ns)] == [
        "smrf.gridding", "inpaint.springs", "smrf.low_outliers",
        "smrf.ladder", "inpaint.springs", "smrf.spline",
        "smrf.inverse_affine", "smrf.points"]
    for s in spans:
        assert s.root == call.id
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    grid = [s for s in spans if by_id.get(s.parent, call).name
            == "smrf.gridding" and s is not call]
    assert sorted(s.name for s in grid) == ["pointgrid.bin",
                                            "pointgrid.scatter"]
    thomas = [s for s in spans if s.name == "spline.thomas"]
    assert len(thomas) == 6 and all(by_id[s.parent].name == "smrf.spline"
                                    for s in thomas)
    springs = sorted((s for s in spans if s.name == "inpaint.springs"),
                     key=lambda s: s.start_ns)
    assert [s.attr for s in springs] == fills and len(fills) == 2
    assert all(f["iterations"] >= 1 for f in fills)


def test_a_fill_span_carries_what_return_info_reports():
    A = torch.from_numpy(np.random.default_rng(2).normal(size=(80, 90))
                         .cumsum(0).astype(np.float32))
    A[10:40, 20:60] = float("nan")
    with _profile():
        pass
    profiling.clear_spans()
    with _profile():
        _, info = ntt.inpaint_nans_by_springs(A, return_info=True,
                                              device="cpu")
    (s,) = profiling.spans()
    assert s.name == "inpaint.springs" and s.parent is None
    assert s.attr == {"iterations": info["iterations"],
                      "host_syncs": info["host_syncs"], "graph": "eager",
                      "replays": 0, "kcycle": "torch"}


def test_without_a_profile_no_span_is_recorded():
    profiling.clear_spans()
    x, y, z = cloud(22, 8_000, 90.0)
    port(x, y, z)
    assert profiling.spans() == []


# ----------------------------------------------------------------------
# the readers of the six per-layer metrics
# ----------------------------------------------------------------------
MS = 1_000_000


def fake(name, t0, t1, sid, parent=None, root=None, device_ms=None,
         attr=None):
    return types.SimpleNamespace(name=name, start_ns=t0, end_ns=t1, id=sid,
                                 parent=parent, root=root or sid,
                                 device_ms=device_ms, attr=attr,
                                 thread="MainThread")


# two calls of 1 s: fills of 300 + 500 and 350 + 450 device ms (4, 7, 5
# and 6 iterations; the first captured its graphs, three replayed them),
# ladders of 60 and 70 ms, the host's binning 20 and 30 ms and inverse
# affine 10 ms each; a fill outside any call and a call outside the
# window
SMRF = [fake("smrf.call", 0, 1000 * MS, 1),
        fake("smrf.gridding", 0, 40 * MS, 2, 1, 1),
        fake("pointgrid.bin", 0, 20 * MS, 3, 2, 1),
        fake("inpaint.springs", 40 * MS, 300 * MS, 4, 1, 1, 300.0,
             {"iterations": 4, "host_syncs": 4, "graph": "captured",
              "replays": 5}),
        fake("smrf.ladder", 300 * MS, 400 * MS, 5, 1, 1, 60.0),
        fake("inpaint.springs", 400 * MS, 900 * MS, 6, 1, 1, 500.0,
             {"iterations": 7, "host_syncs": 7, "graph": "replayed",
              "replays": 8}),
        fake("smrf.inverse_affine", 900 * MS, 910 * MS, 7, 1, 1),
        fake("smrf.call", 1000 * MS, 2000 * MS, 8),
        fake("pointgrid.bin", 1000 * MS, 1030 * MS, 9, 8, 8),
        fake("inpaint.springs", 1100 * MS, 1400 * MS, 10, 8, 8, 350.0,
             {"iterations": 5, "host_syncs": 5, "graph": "replayed",
              "replays": 6}),
        fake("smrf.ladder", 1400 * MS, 1500 * MS, 11, 8, 8, 70.0),
        fake("inpaint.springs", 1500 * MS, 1900 * MS, 12, 8, 8, 450.0,
             {"iterations": 6, "host_syncs": 6, "graph": "replayed",
              "replays": 7}),
        fake("smrf.inverse_affine", 1900 * MS, 1910 * MS, 13, 8, 8),
        fake("inpaint.springs", 1950 * MS, 1960 * MS, 14, None, None, 9.0,
             {"iterations": 99, "host_syncs": 99, "graph": "eager",
              "replays": 0}),
        fake("smrf.call", 3000 * MS, 4000 * MS, 15)]
READERS = {"smrf.fill_ms_per_call": 800.0,
           "inpaint.cg_iters_per_fill": 5.5,
           "smrf.ladder_ms_per_call": 65.0,
           "smrf.host_pct": 3.5,
           "inpaint.graph_replay_pct": 75.0}


def reader(name):
    return harness.load_module(harness.BASE / "metrics" / f"{name}.py",
                               f"portbench.metrics.{name}")


@pytest.mark.parametrize("name", sorted(READERS))
def test_span_readers(monkeypatch, name):
    read = reader(name).read
    trace = types.SimpleNamespace(window=(0, 2000 * MS), busy=[])
    run = harness.Run(jobs=[], trace=trace)
    monkeypatch.setattr(profiling, "spans", lambda: list(SMRF))
    assert read(run) == pytest.approx(READERS[name])
    assert read(harness.Run(jobs=[], trace=None)) is None
    # a program without these spans (the parent commit) reads None
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert read(run) is None
    monkeypatch.delattr(profiling, "spans")
    assert read(run) is None


def test_graph_replay_share_reads_none_for_fills_without_graph_attr(
        monkeypatch):
    """The parent commit's fills carry only ``iterations`` and
    ``host_syncs``: ``inpaint.graph_replay_pct`` then reads None, and
    every fill replayed reads 100."""
    read = reader("inpaint.graph_replay_pct").read
    trace = types.SimpleNamespace(window=(0, 2000 * MS), busy=[])
    run = harness.Run(jobs=[], trace=trace)
    parent = [types.SimpleNamespace(**{**vars(s), "attr": {
        k: v for k, v in s.attr.items() if k in ("iterations",
                                                 "host_syncs")}})
              if isinstance(s.attr, dict) else s for s in SMRF]
    monkeypatch.setattr(profiling, "spans", lambda: parent)
    assert read(run) is None
    replayed = [types.SimpleNamespace(**{**vars(s), "attr": {
        **s.attr, "graph": "replayed"}}) if isinstance(s.attr, dict) else s
                for s in SMRF]
    monkeypatch.setattr(profiling, "spans", lambda: replayed)
    assert read(run) == 100.0


def test_launches_and_idle_readers():
    device = [("kernel_a", 10, 20), ("Memcpy HtoD (Pageable -> Device)",
                                     20, 30),
              ("kernel_b", 30, 40), ("Memset (Device)", 40, 45),
              ("kernel_c", 120, 130), ("kernel_d", 150, 160),
              ("kernel_e", 170, 180), ("kernel_f", 300, 310)]
    trace = types.SimpleNamespace(device=device, jobs=[(0, 100),
                                                       (100, 200)],
                                  idle_pct=lambda: 42.0)
    run = harness.Run(jobs=[], trace=trace)
    assert reader("smrf.launches_per_job").read(run) == 2.5
    assert reader("device.idle_pct.smrf").read(run) == 42.0
    trace.device = [d for d in device if d[0].startswith("Mem")]
    assert reader("smrf.launches_per_job").read(run) is None
    for name in ("smrf.launches_per_job", "device.idle_pct.smrf"):
        assert reader(name).read(harness.Run(jobs=[], trace=None)) is None


# ----------------------------------------------------------------------
# the manifest
# ----------------------------------------------------------------------
MAN = json.loads((REPO / "BENCHMARK.json").read_text())
# sha256 (first 16 hex digits) of each list as the parent commit had it,
# ``json.dumps(..., sort_keys=True)``
BEFORE = {"configs": (2, "4e291c418ab444b6"),
          "workloads": (4, "36ef6ddc5c92c869"),
          "end_to_end": (6, "2b40f74d38aee395"),
          "per_layer": (14, "5759c8cc65d710e3")}
NEW_METRICS = ["device.idle_pct.smrf", "smrf.launches_per_job",
               "smrf.fill_ms_per_call", "inpaint.cg_iters_per_fill",
               "smrf.ladder_ms_per_call", "smrf.host_pct"]
# appended after the cell's own: the springs fill's CUDA graph replays,
# then the spline coefficients' device time and kernel share
LATER_METRICS = ["inpaint.graph_replay_pct", "smrf.spline_ms_per_call",
                 "spline.kernel_sweep_pct"]
# appended to every cell: the port's start-up
STARTUP_METRICS = ["setup.import_s", "setup.library_s", "setup.first_use_s"]


def _digest(x):
    return hashlib.sha256(json.dumps(x, sort_keys=True).encode()) \
        .hexdigest()[:16]


@pytest.mark.parametrize("kind", sorted(BEFORE))
def test_entries_that_were_there_are_unchanged_but_two_appended_names(kind):
    n, digest = BEFORE[kind]
    old = json.loads(json.dumps(MAN[kind][:n]))
    # cells added after this one may be appended to a metric's list
    later = {w["name"] for w in MAN["workloads"][5:]}
    for m in old:
        if "workloads" in m:
            m["workloads"] = [w for w in m["workloads"] if w not in later]
        if m["name"] in ("raster_mpix_s.host", "job_p95_ms.host"):
            assert m["workloads"][-1] == CELL
            m["workloads"].pop()
    assert _digest(old) == digest


def test_the_new_entries():
    (cfg,) = MAN["configs"][2:3]
    assert cfg["name"] == "smrf_isprs" and cfg["reduced"] == []
    assert cfg["file"] == "portbench/configs/smrf_isprs.json"
    assert cfg["source"] == CFG["source"] and len(cfg["source"]) <= 200
    (cell,) = MAN["workloads"][4:5]
    assert (cell["name"], cell["config"], cell["traffic"], cell["chips"]) \
        == (CELL, "smrf_isprs", "tile5m", 1)
    new = MAN["per_layer"][14:23]
    assert [m["name"] for m in new] == NEW_METRICS + LATER_METRICS
    for m in new:
        assert m["workloads"] == [CELL]
        assert m["moves"] == "raster_mpix_s.host"
        assert (harness.BASE / "metrics" / f"{m['name']}.py").is_file()
    spec = harness.CellSpec(CELL)
    assert {m["name"] for m in spec.metrics("end_to_end")} == {
        "raster_mpix_s.host", "job_p95_ms.host", "setup_s"}
    # the cell's own metrics, and those later PRs appended to it
    assert [m["name"] for m in spec.metrics("per_layer")] == \
        NEW_METRICS + LATER_METRICS + ["inpaint.kcycle_kernel_pct"] \
        + STARTUP_METRICS


def test_the_configuration_is_the_published_set_and_its_traffic():
    assert (CFG["cellsize"], CFG["windows"], CFG["slope_threshold"],
            CFG["elevation_threshold"], CFG["elevation_scaler"]) \
        == (1.0, 18, 0.15, 0.5, 1.25)
    assert (CFG["points"], CFG["extent"], CFG["precision"],
            CFG["chunk_points"]) == (5_000_000, 2000.0, "fast", 2_000_000)
    traffic = json.loads((REPO / "portbench/traffic/tile5m.json")
                         .read_text())
    assert traffic == {"inputs": 4, "call": {}, "sample_outputs": 2}
    assert set(CFG["limits_why"]) == set(LIMITS)
    # the timed call leaves these to the package's defaults
    defaults = inspect.signature(ntt.smrf).parameters
    for key in ("precision", "chunk_points", "low_filter_slope"):
        assert defaults[key].default == CFG[key]
