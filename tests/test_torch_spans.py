"""The port's spans (``neilpy_tpu_torch.profiling.span``) and the
benchmark's readers of them.

Off, with no profiler open, a span is one shared null context and the
record stays empty; on, a CPU mosaic call records its layers on the
caller's, the producer's and the writer's threads under one root, each
``tiling.*`` span timing the interval of the ``phase_stats`` key it
echoes, on the clock of the profiler's own events; ``profiling.trace``
writes every thread's spans; the moments span names the path it took;
``openness_pair`` and ``skyview_factor`` are root spans naming their
route; each ``portbench/metrics`` reader of them gives its value on a
hand-built record.  No JAX here: the ``cuda`` cases (the launch span's
C entry and device time, under ``geomorphons`` and under the fused
reductions' roots, the moments pass on the card) run on a card
with ``python3 -m pytest --noconftest -p no:cacheprovider
tests/test_torch_spans.py -m cuda``."""

import contextlib
import glob
import json
import os
import statistics
import sys
import threading
import types

import numpy as np
import pytest
import torch

import neilpy_tpu_torch as ntt
from neilpy_tpu_torch import profiling
from portbench import harness

torch.set_num_threads(1)

TILE = 64
# 256^2 in 64^2 tiles through the host path, so the producer reads
MOSAIC_KW = dict(cellsize=10, lookup_pixels=8, windows=np.array([1, 2]),
                 gi_radius=2, tile_size=TILE, prefetch=True,
                 device_input=False, device="cpu")
# phase_stats key -> the span that times the same interval
ECHO = {"host_read": "tiling.read", "upload": "tiling.upload",
        "dispatch": "tiling.dispatch",
        "readback_wait": "tiling.readback_wait",
        "store_wait": "tiling.store_wait", "total": "tiling.loop"}


def dem(n=256, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, n)).astype(np.float32).cumsum(0).cumsum(1)


def cpu_profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def traced(fn):
    """(spans, profile) of ``fn()`` under a CPU profile, after one traced
    call that warms the profiler's first record function."""
    with cpu_profile():
        fn()
    profiling.clear_spans()
    with cpu_profile() as prof:
        fn()
    return profiling.spans(), prof


def dur(spans):
    return sum(s.end_ns - s.start_ns for s in spans) / 1e9


def test_off_a_span_is_one_shared_null_context_and_records_nothing():
    profiling.clear_spans()
    a = profiling.span("visibility.geomorphons")
    b = profiling.span("tiling.loop", parent=None, device="cpu", attr="x")
    assert a is b and isinstance(a, contextlib.nullcontext)
    assert profiling.device_time(torch.device("cpu")) is a
    with a as s:
        assert s is None
    ntt.geomorphons(dem(64), cellsize=10, lookup_pixels=8, device="cpu")
    ntt.mosaic_terrain_products(dem(), **MOSAIC_KW)
    assert profiling.spans() == []


@pytest.fixture(scope="module")
def mosaic_trace():
    Z = dem()
    stats = {}

    def call():
        stats.clear()
        ntt.mosaic_terrain_products(Z, phase_stats=stats, **MOSAIC_KW)

    spans, prof = traced(call)
    return spans, prof, dict(stats)


def test_a_mosaic_call_records_its_layers_on_three_threads(mosaic_trace):
    spans, _, stats = mosaic_trace
    by_id = {s.id: s for s in spans}
    (call,) = [s for s in spans if s.name == "mosaic.call"]
    (moments,) = [s for s in spans if s.name == "mosaic.moments"]
    (loop,) = [s for s in spans if s.name == "tiling.loop"]
    assert call.parent is None and call.thread == "MainThread"
    for s in (moments, loop):
        assert s.parent == call.id and s.thread == "MainThread"
        assert call.start_ns <= s.start_ns <= s.end_ns <= call.end_ns
    assert {s.root for s in spans} == {call.id}
    stores = [s for s in spans if s.name == "tiling.store"]
    assert len(stores) == stats["tiles"] == (256 // TILE) ** 2
    assert all(s.thread.startswith("tiling.writer") and s.parent == loop.id
               for s in stores)
    for name in ("tiling.unpack", "tiling.write_out"):
        kids = [s for s in spans if s.name == name]
        assert len(kids) == len(stores)
        assert all(by_id[s.parent].name == "tiling.store" for s in kids)
    reads = [s for s in spans if s.name == "tiling.read"]
    assert len(reads) == len(stores)
    assert all(s.thread == "tiling.producer" and s.parent == loop.id
               for s in reads)
    assert all(loop.start_ns <= s.start_ns and s.end_ns <= loop.end_ns
               for s in stores + reads)


@pytest.mark.parametrize("path", ["host", "sidecar"])
def test_the_moments_span_names_the_path_taken(tmp_path, path):
    """CPU tiles take the numpy pass; a checkpoint's trusted sidecar
    takes none."""
    ck = str(tmp_path / "mosaic.json")
    if path == "sidecar":
        ntt.mosaic_terrain_products(dem(), checkpoint=ck, **MOSAIC_KW)
        os.remove(ck)              # the tiles run again, the moments not
    profiling.clear_spans()
    with cpu_profile():
        ntt.mosaic_terrain_products(dem(), checkpoint=ck, **MOSAIC_KW)
    (moments,) = [s for s in profiling.spans()
                  if s.name == "mosaic.moments"]
    assert moments.attr == path


# the fused reductions' public calls and their root spans
REDUCED = {"openness_pair": "visibility.openness_pair",
           "skyview_factor": "visibility.skyview_factor"}


@pytest.mark.parametrize("fn", sorted(REDUCED))
def test_a_fused_reduction_call_is_a_root_naming_its_route(fn):
    call_fn = getattr(ntt, fn)
    kw = dict(cellsize=10, lookup_pixels=8, device="cpu")
    profiling.clear_spans()
    call_fn(dem(64), **kw)
    assert profiling.spans() == []
    with cpu_profile():
        call_fn(dem(64), **kw)
    spans = profiling.spans()
    (call,) = [s for s in spans if s.parent is None]
    assert call.name == REDUCED[fn] and call.attr == "torch"
    (child,) = [s for s in spans if s is not call]
    assert child.name == "visibility.as_raster"
    assert child.parent == child.root == call.id
    assert call.start_ns <= child.start_ns <= child.end_ns <= call.end_ns


@pytest.mark.parametrize("fn, kw, route", [
    ("openness_pair", {}, "plan"),
    ("openness_pair", {"fast": True}, "dynamic"),
    ("openness_pair", {"fast": True, "specialize": True}, "plan"),
    ("openness_pair", {"specialize": False}, "dynamic"),
    ("skyview_factor", {}, "plan")])
def test_the_root_names_the_route_a_card_takes(fn, kw, route):
    """``engine='cuda'`` on a CPU tensor: the root records the kernel's
    route, then the kernel refuses the tensor."""
    profiling.clear_spans()
    with cpu_profile():
        with pytest.raises(ValueError, match="CUDA tensor"):
            getattr(ntt, fn)(dem(32), 10, 4, engine="cuda", device="cpu",
                             **kw)
    (call,) = [s for s in profiling.spans() if s.name == REDUCED[fn]]
    assert call.parent is None and call.attr == route


def test_openness_nests_the_pairs_span_in_its_caller():
    profiling.clear_spans()
    with cpu_profile():
        with profiling.span("caller") as caller:
            ntt.openness(dem(32), 10, 4, device="cpu")
    (pair,) = [s for s in profiling.spans()
               if s.name == "visibility.openness_pair"]
    assert pair.parent == pair.root == caller.id and pair.attr == "torch"


@pytest.mark.parametrize("key", sorted(ECHO))
def test_each_phase_equals_the_self_time_of_its_spans(mosaic_trace, key):
    spans, _, stats = mosaic_trace
    by_id = {s.id: s for s in spans}
    got = dur([s for s in spans if s.name == ECHO[key]])
    if key == "dispatch":
        # a dispatch's waits for a free readback buffer are store_wait
        got -= dur([s for s in spans if s.name == "tiling.store_wait"
                    and s.parent in by_id
                    and by_id[s.parent].name == "tiling.dispatch"])
    assert got == pytest.approx(stats[key], abs=max(1e-3, 0.01 * stats[key]))


def _edges(spans, prof):
    """|span edge - profiler event edge| in microseconds, start and end,
    for every main-thread span, matched by name in start order."""
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CPU:
            events.setdefault(e.name(), []).append(e)
    for v in events.values():
        v.sort(key=lambda e: e.start_ns())
    seen, out = {}, []
    main = sorted((s for s in spans if s.thread == "MainThread"),
                  key=lambda s: s.start_ns)
    for s in main:
        k = seen[s.name] = seen.get(s.name, -1) + 1
        e = events[s.name][k]
        out += [abs(s.start_ns - e.start_ns()) / 1e3,
                abs(s.end_ns - e.start_ns() - e.duration_ns()) / 1e3]
    return out


def test_main_thread_spans_are_on_the_clock_of_the_profilers_events(
        mosaic_trace):
    """Every main-thread span is also a profiler event of its name, and
    its edges are read just after the event's stamps: a clock offset or
    drift (``perf_counter`` is ~1e18 ns off) shows at once.  The
    scheduler may hold a thread between a stamp and the read, so the
    typical edge is held to 50 us and every edge to 1 ms."""
    spans, prof, _ = mosaic_trace
    geo, gprof = traced(lambda: [ntt.geomorphons(
        dem(128), cellsize=10, lookup_pixels=8, device="cpu")
        for _ in range(10)])
    for s, p in ((spans, prof), (geo, gprof)):
        d = _edges(s, p)
        assert len(d) >= 2 * 30
        assert statistics.median(d) < 50, sorted(d)[-10:]
        assert sum(x < 50 for x in d) >= 0.9 * len(d), sorted(d)[-10:]
        assert max(d) < 1000, sorted(d)[-10:]


def test_trace_writes_the_spans_of_every_thread(tmp_path):
    with profiling.trace(str(tmp_path)):
        ntt.mosaic_terrain_products(dem(), **MOSAIC_KW)
    (path,) = glob.glob(os.path.join(str(tmp_path), "*.json"))
    with open(path) as f:
        doc = json.load(f)
    ours = [e for e in doc["traceEvents"] if e.get("cat") == "span"]
    tracks = {e["tid"] for e in ours}
    assert {"MainThread", "tiling.producer"} <= tracks
    stores = [e for e in ours if e["name"] == "tiling.store"]
    assert len(stores) == (256 // TILE) ** 2
    assert all(e["tid"].startswith("tiling.writer") for e in stores)
    # on the file's time origin: inside the profiler's own events
    base = [e["ts"] for e in doc["traceEvents"]
            if e.get("ph") == "X" and e.get("cat") != "span"]
    (call,) = [e for e in ours if e["name"] == "mosaic.call"]
    assert min(base) - 1e3 <= call["ts"] <= max(base)


def test_spans_of_many_threads_keep_their_own_parents():
    """More threads than cores, switching every microsecond: each thread's
    spans nest under its own, none is lost and every id is distinct."""
    n_threads, n_spans = 16, 50
    switch = sys.getswitchinterval()
    profiling.clear_spans()
    try:
        sys.setswitchinterval(1e-6)
        with cpu_profile():
            with profiling.span("root") as root:
                def work():
                    for _ in range(n_spans):
                        with profiling.span("outer", parent=root):
                            with profiling.span("inner"):
                                pass
                threads = [threading.Thread(target=work, name=f"w{i}")
                           for i in range(n_threads)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=60)
                assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    spans = profiling.spans()
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans) == 1 + 2 * n_threads * n_spans
    for s in spans:
        if s.name == "inner":
            p = by_id[s.parent]
            assert p.name == "outer" and p.thread == s.thread
        if s.name != "root":
            assert s.root == root.id


# ----------------------------------------------------------------------
# the benchmark's readers of the spans
# ----------------------------------------------------------------------
def fake(name, t0, t1, sid, parent=None, root=None, device_ms=None):
    return types.SimpleNamespace(name=name, start_ns=t0, end_ns=t1, id=sid,
                                 parent=parent, root=root or sid,
                                 device_ms=device_ms, thread="MainThread")


MS = 1_000_000
# two geomorphons calls: K5's launch 6 ms and the gather 1.6 ms on the
# device; the second call has no gather span (as after a fused epilogue),
# and one span lies outside the window
GEO = [fake("visibility.geomorphons", 0, 2 * MS, 1),
       fake("cuda_scan.launch", MS // 10, MS // 10 + 40_000, 2, 1, 1, 6.0),
       fake("visibility.classes_from_counts", MS, 2 * MS, 3, 1, 1, 1.6),
       fake("visibility.geomorphons", 10 * MS, 11 * MS, 4),
       fake("cuda_scan.launch", 10 * MS, 10 * MS + 60_000, 5, 4, 4, 6.2),
       fake("visibility.geomorphons", 200 * MS, 201 * MS, 6)]
# two mosaic calls of 1 s, moments 0.6 and 0.5 s, loops of 0.4 s with
# the device busy 0.1 s in each, three stores of 20, 30 and 40 ms
MOSAIC = [fake("mosaic.call", 0, 1000 * MS, 1),
          fake("mosaic.moments", 0, 600 * MS, 2, 1, 1),
          fake("tiling.loop", 600 * MS, 1000 * MS, 3, 1, 1),
          fake("tiling.store", 700 * MS, 720 * MS, 4, 3, 1),
          fake("tiling.store", 800 * MS, 830 * MS, 5, 3, 1),
          fake("mosaic.call", 1000 * MS, 2000 * MS, 6),
          fake("mosaic.moments", 1000 * MS, 1500 * MS, 7, 6, 6),
          fake("tiling.loop", 1600 * MS, 2000 * MS, 8, 6, 6),
          fake("tiling.store", 1700 * MS, 1740 * MS, 9, 8, 6)]
READERS = {
    "geomorphons.host_ms_per_call": (GEO, 1.5),
    "cuda_scan.launch_host_us": (GEO, 50.0),
    "kernels.ladder_ms_per_call": (GEO, 6.1),
    "geomorphons.classes_ms_per_call": (GEO, 0.8),
    "mosaic.moments_pct": (MOSAIC, 55.0),
    "tiling.store_ms_per_tile": (MOSAIC, 30.0),
    "tiling.loop_idle_pct": (MOSAIC, 75.0),
}


def reader(name):
    return harness.load_module(harness.BASE / "metrics" / f"{name}.py",
                               f"portbench.metrics.{name}")


@pytest.mark.parametrize("name", sorted(READERS))
def test_span_readers(monkeypatch, name):
    spans, want = READERS[name]
    read = reader(name).read
    busy = [[650 * MS, 700 * MS], [900 * MS, 950 * MS],
            [1700 * MS, 1800 * MS]]
    trace = types.SimpleNamespace(window=(0, 100 * MS if spans is GEO
                                          else 2000 * MS), busy=busy)
    run = harness.Run(jobs=[], trace=trace)
    monkeypatch.setattr(profiling, "spans", lambda: list(spans))
    assert read(run) == pytest.approx(want)
    assert read(harness.Run(jobs=[], trace=None)) is None
    # a program without spans reads None, as the parent commit does
    monkeypatch.delattr(profiling, "spans")
    assert read(run) is None


# ----------------------------------------------------------------------
# the DEM products
# ----------------------------------------------------------------------
def voided(n=64):
    Z = torch.from_numpy(dem(n))
    Z[20:26, 30:37] = float("nan")
    return Z


def dem_products(Z):
    """The DEM-products cell's job: (hillshade, ESRI's triple, the
    landslide mask at radii (2, 3))."""
    return (ntt.hillshade(Z, 10, device=Z.device),
            ntt.esri_curvature(Z, 10, device=Z.device),
            ntt.shi_landslides(Z, (2, 3), 10, device=Z.device))


def test_the_dem_products_are_three_roots_with_the_statistics_nested():
    Z = voided()
    profiling.clear_spans()
    dem_products(Z)
    assert profiling.spans() == []
    with cpu_profile():
        dem_products(Z)
    spans = profiling.spans()
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["surface.hillshade",
                                       "surface.esri_curvature",
                                       "stats.shi_landslides"]
    shi = roots[2]
    assert shi.attr == (2, 3)
    kids = [s for s in spans if s.parent is not None]
    assert [s.name for s in kids] == ["surface.evans_curvature",
                                      "stats.rasterGi", "stats.rasterGi"]
    assert all(s.parent == s.root == shi.id for s in kids)
    assert [s.attr for s in kids[1:]] == [
        {"footprint": (5, 5), "star": True, "path": "torch"},
        {"footprint": (7, 7), "star": True, "path": "torch"}]
    assert all(shi.start_ns <= s.start_ns <= s.end_ns <= shi.end_ns
               for s in kids)
    # CUDA events only on a card
    assert all(s.device_ms is None for s in spans)


@pytest.mark.parametrize("fn, kw, name, attr", [
    ("hillshade", {"cellsize": 10}, "surface.hillshade", None),
    ("esri_curvature", {"cellsize": 10}, "surface.esri_curvature", None),
    ("evans_curvature", {"cellsize": 10}, "surface.evans_curvature", None),
    ("rasterGi", {"footprint": 1}, "stats.rasterGi",
     {"footprint": (3, 3), "star": False, "path": "torch"}),
    ("rasterGi", {"footprint": 2, "star": True}, "stats.rasterGi",
     {"footprint": (5, 5), "star": True, "path": "torch"})])
def test_a_public_call_is_one_root_span(fn, kw, name, attr):
    profiling.clear_spans()
    with cpu_profile():
        getattr(ntt, fn)(voided(32), device="cpu", **kw)
    (call,) = profiling.spans()
    assert (call.name, call.parent, call.attr) == (name, None, attr)


@pytest.mark.parametrize("module, fn, args", [
    ("stats", "local_morans_i", (1,)), ("stats", "morans_i", (1,)),
    ("surface", "binary_footprint_sum", (np.ones((3, 3)),))])
def test_the_footprint_sums_and_morans_open_no_span(module, fn, args):
    """The mosaic's tile program runs these: its traced window records
    no span of the DEM products."""
    call = getattr(getattr(ntt.ops, module), fn)
    profiling.clear_spans()
    with cpu_profile():
        call(voided(32), *args, device="cpu")
    assert profiling.spans() == []


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda:0"


@pytest.mark.cuda
@pytest.mark.parametrize("fast, entry", [
    (False, "openness_counts_plan_launch"),   # K5 on the exact ladder
    (True, "openness_counts_launch")])        # K1 on the fast one
def test_launch_span_names_its_entry_and_times_the_device(cuda_device, fast,
                                                          entry):
    Z = torch.from_numpy(dem(1024)).to(cuda_device)
    kw = dict(cellsize=10, lookup_pixels=50, fast=fast)
    ntt.geomorphons(Z, **kw)
    torch.cuda.synchronize()
    profiling.clear_spans()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        ntt.geomorphons(Z, **kw)
        torch.cuda.synchronize()
    spans = profiling.spans()
    (call,) = [s for s in spans if s.name == "visibility.geomorphons"]
    (launch,) = [s for s in spans if s.name == "cuda_scan.launch"]
    (classes,) = [s for s in spans
                  if s.name == "visibility.classes_from_counts"]
    assert launch.attr == entry and launch.root == call.id
    assert launch.device_ms > 0 and classes.device_ms > 0
    assert call.start_ns <= launch.start_ns <= launch.end_ns <= call.end_ns


@pytest.mark.cuda
@pytest.mark.parametrize("fn", sorted(REDUCED))
def test_a_fused_reduction_launch_sits_under_its_root(cuda_device, fn):
    Z = torch.from_numpy(dem(1024)).to(cuda_device)
    kw = dict(cellsize=10, lookup_pixels=50)
    getattr(ntt, fn)(Z, **kw)
    torch.cuda.synchronize()
    profiling.clear_spans()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        getattr(ntt, fn)(Z, **kw)
        torch.cuda.synchronize()
    spans = profiling.spans()
    (call,) = [s for s in spans if s.name == REDUCED[fn]]
    (launch,) = [s for s in spans if s.name == "cuda_scan.launch"]
    assert call.parent is None and call.attr == "plan"
    assert launch.attr == "openness_reduced_plan_launch"
    assert launch.parent == launch.root == call.id
    assert launch.device_ms > 0
    assert call.start_ns <= launch.start_ns <= launch.end_ns <= call.end_ns


@pytest.mark.cuda
def test_the_moments_span_names_the_card_path(cuda_device):
    kw = dict(MOSAIC_KW, device=cuda_device)
    ntt.mosaic_terrain_products(dem(), **kw)
    profiling.clear_spans()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        ntt.mosaic_terrain_products(dem(), **kw)
    (moments,) = [s for s in profiling.spans()
                  if s.name == "mosaic.moments"]
    assert moments.attr == "cuda"


@pytest.mark.cuda
def test_the_dem_products_time_the_device(cuda_device):
    Z = voided(1024).to(cuda_device)
    dem_products(Z)
    torch.cuda.synchronize()
    profiling.clear_spans()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        dem_products(Z)
        torch.cuda.synchronize()
    spans = profiling.spans()
    assert sorted(s.name for s in spans) == [
        "stats.rasterGi", "stats.rasterGi", "stats.shi_landslides",
        "surface.esri_curvature", "surface.evans_curvature",
        "surface.hillshade"]
    for s in spans:
        if s.name == "stats.shi_landslides":
            assert s.device_ms is None
        else:
            assert s.device_ms > 0
