"""The port's start-up spans (``neilpy_tpu_torch.profiling.once``) and the
benchmark's readers of them.

A once-span records with no profile open, where ``span`` stays one shared
null context: the package's import (``startup.import``), a library's
``build.library`` with its ``build.hash``, ``build.compile`` (only when it
compiled) and ``build.load``, each C entry's first launch
(``first_use.launch``, once a process) and each CUDA graph capture
(``first_use.graph_capture``).  The readers ``setup.import_s``,
``setup.library_s`` and ``setup.first_use_s`` keep the spans that end
before the traced window and count a first use nested in another once.
No JAX here: the ``cuda`` cases (each launch site's first use, the graph
capture, the CUDA library's load) run on a card with ``python3 -m pytest
--noconftest -p no:cacheprovider tests/test_torch_startup_spans.py -m
cuda``."""

import json
import os
import subprocess
import sys
import threading
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import neilpy_tpu_torch as ntt
from neilpy_tpu_torch import _build, _host_build, profiling
from neilpy_tpu_torch.ops import binning_native, inpaint, spline, stats
from neilpy_tpu_torch.ops import surface
from portbench import harness

REPO = Path(__file__).resolve().parent.parent
MS = 1_000_000


def dur(s):
    return s.end_ns - s.start_ns


def names(spans):
    return [s.name for s in spans]


# ----------------------------------------------------------------------
# the spans
# ----------------------------------------------------------------------
def test_a_once_span_records_with_no_profile_open():
    profiling.clear_spans()
    assert not torch.autograd.profiler._is_profiler_enabled
    with profiling.once("outer.once", attr={"k": 1}) as outer:
        assert isinstance(outer, profiling.Span)
        null = profiling.span("inner.span")
        assert null is profiling.span("other") and null.__enter__() is None
        with profiling.once("inner.once") as inner:
            pass
    assert profiling.spans() == [inner, outer]
    assert outer.parent is None and outer.root == outer.id
    assert inner.parent == outer.id and inner.root == outer.id
    assert outer.attr == {"k": 1} and inner.attr is None
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert inner.thread == outer.thread == threading.current_thread().name
    profiling.clear_spans()


def test_a_once_span_may_start_before_its_block():
    profiling.clear_spans()
    t0 = profiling.time.time_ns() - 5 * MS
    with profiling.once("late.once", start_ns=t0) as s:
        pass
    assert s.start_ns == t0 and dur(s) >= 5 * MS
    assert profiling.spans() == [s]
    profiling.clear_spans()


def test_under_a_profile_a_once_span_is_also_a_profiler_event():
    profiling.clear_spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.once("profiled.once"):
            torch.ones(4).add_(1)
    (s,) = profiling.spans()
    assert s.name == "profiled.once"
    assert "profiled.once" in {e.name for e in prof.events()}
    profiling.clear_spans()


def test_a_first_launch_records_once_per_entry(monkeypatch):
    monkeypatch.setattr(profiling, "_LAUNCHED", set())
    profiling.clear_spans()
    for _ in range(3):
        for entry in ("a_launch", "b_launch"):
            with profiling.first_launch(entry):
                pass
    assert [(s.name, s.attr) for s in profiling.spans()] == [
        ("first_use.launch", "a_launch"), ("first_use.launch", "b_launch")]
    # a later call is the shared null context, as an unprofiled span is
    assert profiling.first_launch("a_launch") is profiling.span("x")
    profiling.clear_spans()


def test_a_first_launch_from_many_threads_records_once(monkeypatch):
    """More threads than cores, switching every microsecond, all on their
    first launch of one entry: one span, on one of their threads."""
    monkeypatch.setattr(profiling, "_LAUNCHED", set())
    profiling.clear_spans()
    switch = sys.getswitchinterval()
    go = threading.Barrier(16)

    def work():
        go.wait()
        for _ in range(50):
            with profiling.first_launch("shared_launch"):
                pass

    try:
        sys.setswitchinterval(1e-6)
        threads = [threading.Thread(target=work, name=f"w{i}")
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    (s,) = profiling.spans()
    assert (s.name, s.attr) == ("first_use.launch", "shared_launch")
    assert s.thread.startswith("w")
    profiling.clear_spans()


def test_a_fresh_import_is_one_startup_span():
    code = ("import json, neilpy_tpu_torch\n"
            "from neilpy_tpu_torch import profiling\n"
            "print(json.dumps([[s.name, s.start_ns, s.end_ns, s.parent]\n"
            "                  for s in profiling.spans()]))\n")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    ((name, start, end, parent),) = json.loads(out.stdout.splitlines()[-1])
    assert name == "startup.import" and parent is None
    assert 0 < end - start
    # the package leaves no name of its own behind for the stamp
    assert not {"_IMPORT", "_IMPORT_NS", "_time"} & set(vars(ntt))


@pytest.fixture
def host_build_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(_host_build, "BUILD_DIR", tmp_path / "host")
    monkeypatch.setattr(_host_build, "_LOADED", {})
    profiling.clear_spans()
    yield tmp_path / "host"
    profiling.clear_spans()


def library_tree():
    """(the build.library span, its children's names in start order)."""
    spans = profiling.spans()
    (lib,) = [s for s in spans if s.name == "build.library"]
    kids = sorted((s for s in spans if s.parent == lib.id),
                  key=lambda s: s.start_ns)
    for s in kids:
        assert lib.start_ns <= s.start_ns <= s.end_ns <= lib.end_ns
    return lib, names(kids)


def test_a_host_library_load_records_its_hash_compile_and_load(
        host_build_dir, monkeypatch):
    lib = _host_build.load("binning", binning_native._declare)
    assert lib is not None and any(host_build_dir.glob("libbinning_*.so"))
    span, kids = library_tree()
    assert span.parent is None
    assert span.attr == {"library": "binning", "built": True}
    assert kids == ["build.hash", "build.compile", "build.load"]
    # the next process finds the library: no compile
    monkeypatch.setattr(_host_build, "_LOADED", {})
    profiling.clear_spans()
    lib = _host_build.load("binning", binning_native._declare)
    assert lib is not None
    span, kids = library_tree()
    assert span.attr == {"library": "binning", "built": False}
    assert kids == ["build.hash", "build.load"]
    # loaded: no span at all
    profiling.clear_spans()
    assert _host_build.load("binning", binning_native._declare) is lib
    assert profiling.spans() == []


def test_a_failed_host_load_still_closes_its_spans(host_build_dir,
                                                   monkeypatch):
    monkeypatch.setattr(_host_build.shutil, "which", lambda name: None)
    monkeypatch.delenv("CXX", raising=False)
    with pytest.warns(RuntimeWarning, match="g\\+\\+ not found"):
        assert _host_build.load("binning", binning_native._declare) is None
    span, kids = library_tree()
    assert span.attr == {"library": "binning", "built": False}
    assert kids == ["build.hash"]
    # nothing left open on the thread: the next span is a root
    with profiling.once("after") as after:
        pass
    assert after.parent is None


# ----------------------------------------------------------------------
# the readers
# ----------------------------------------------------------------------
def fake(name, t0, t1, sid, parent=None, attr=None):
    return types.SimpleNamespace(name=name, start_ns=t0 * MS, end_ns=t1 * MS,
                                 id=sid, parent=parent, attr=attr,
                                 thread="MainThread")


# the window opens at 1000 ms: the import 400 ms; the CUDA library 20 ms
# and a host library loaded inside the first capture 30 ms; a first launch
# 30 ms and a capture of 100 ms, inside it (under another span) the
# library and a first launch it counts; inside the window and across its
# start a library load, a first launch and a capture, none counted
RECORD = [fake("startup.import", 0, 400, 1),
          fake("build.hash", 500, 505, 3, 2),
          fake("build.load", 505, 520, 4, 2),
          fake("build.library", 500, 520, 2, attr={"built": False}),
          fake("first_use.launch", 530, 560, 5, attr="a_launch"),
          fake("build.library", 610, 640, 7, 6),
          fake("first_use.launch", 650, 660, 8, 9, attr="b_launch"),
          fake("inpaint.springs", 645, 670, 9, 6),
          fake("first_use.graph_capture", 600, 700, 6),
          fake("first_use.launch", 990, 1010, 12, attr="c_launch"),
          fake("build.library", 1100, 1200, 10),
          fake("first_use.graph_capture", 1300, 1400, 11)]
STARTUP = {"setup.import_s": 0.4, "setup.library_s": 0.05,
           "setup.first_use_s": 0.03 + 0.1 - 0.03}
NAMES = ["setup.import_s", "setup.library_s", "setup.first_use_s"]


def reader(name):
    return harness.load_module(harness.BASE / "metrics" / f"{name}.py",
                               f"portbench.metrics.{name}")


@pytest.mark.parametrize("name", sorted(STARTUP))
def test_startup_readers(monkeypatch, name):
    read = reader(name).read
    trace = types.SimpleNamespace(window=(1000 * MS, 3000 * MS), busy=[])
    run = harness.Run(jobs=[], trace=trace)
    monkeypatch.setattr(profiling, "spans", lambda: list(RECORD))
    assert read(run) == pytest.approx(STARTUP[name])
    assert read(harness.Run(jobs=[], trace=None)) is None
    # spans only inside the window, or none at all: nothing to read
    monkeypatch.setattr(profiling, "spans", lambda: list(RECORD[9:]))
    assert read(run) is None
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert read(run) is None
    # a program without spans reads None, as the parent commit does
    monkeypatch.delattr(profiling, "spans")
    assert read(run) is None


def test_the_manifest_appends_the_startup_metrics():
    man = json.loads((REPO / "BENCHMARK.json").read_text())
    cells = [w["name"] for w in man["workloads"]]
    assert len(cells) == 7
    assert [m["name"] for m in man["per_layer"][35:]] == NAMES
    for m in man["per_layer"][35:]:
        assert m == {"name": m["name"], "unit": "s", "better": "lower",
                     "source": "program_span", "layer": "start-up",
                     "moves": "setup_s", "workloads": cells}
        assert (harness.BASE / "metrics" / f"{m['name']}.py").is_file()
    for cell in cells:
        spec = harness.CellSpec(cell)
        assert "setup_s" in {m["name"] for m in spec.metrics("end_to_end")}
        assert [m["name"] for m in spec.metrics("per_layer")][-3:] == NAMES


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def dem(n, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.normal(size=(n, n)).astype(np.float32).cumsum(0).cumsum(1))


def geomorphons(dev):
    ntt.geomorphons(dem(512).to(dev), cellsize=10, lookup_pixels=20)


def thomas(dev):
    spline._thomas_cuda(torch.ones((64, 80), device=dev))


def footprint(dev):
    surface.binary_footprint_sum(dem(300).to(dev), ntt.disk(3))


def gi(dev):
    stats.rasterGi(dem(300).to(dev), ntt.disk(3), star=True)


# each launch site, a call that reaches it, and its C entry
SITES = {"cuda_scan": (geomorphons, "openness_counts_plan_launch"),
         "spline": (thomas, "thomas_sweep_launch"),
         "surface": (footprint, "footprint_sum_launch"),
         "stats": (gi, "footprint_gi_launch")}


@pytest.mark.cuda
@pytest.mark.parametrize("site", sorted(SITES))
def test_each_entry_records_its_first_launch_once(card, monkeypatch, site):
    call, entry = SITES[site]
    call(card)  # the library loaded, the entry's kernels too
    torch.cuda.synchronize()
    monkeypatch.setattr(profiling, "_LAUNCHED", set())
    profiling.clear_spans()
    call(card)
    torch.cuda.synchronize()
    first = [s for s in profiling.spans() if s.name == "first_use.launch"]
    assert [s.attr for s in first] == [entry]
    profiling.clear_spans()
    call(card)
    torch.cuda.synchronize()
    assert profiling.spans() == []


def fill(dev, n=96, seed=1):
    A = dem(n, seed).double().to(dev)
    A[20:60, 30:70] = float("nan")
    return inpaint._springs_core(A, 1e-7, 400)


@pytest.mark.cuda
def test_a_graph_capture_records_once_per_key_and_not_on_replay(
        card, monkeypatch):
    fill(card)  # the library and the K-cycle's entry loaded
    torch.cuda.synchronize()
    monkeypatch.setattr(inpaint, "_GRAPHS", inpaint._GraphCache(size=1))
    monkeypatch.setattr(profiling, "_LAUNCHED", set())
    profiling.clear_spans()
    assert fill(card)[1]["graph"] == "captured"
    spans = profiling.spans()
    (cap,) = [s for s in spans if s.name == "first_use.graph_capture"]
    assert cap.parent is None and cap.attr == {"shape": [96, 96],
                                               "dtype": "torch.float64"}
    # the K-cycle's first launch ran inside the capture's warm-up
    (launch,) = [s for s in spans if s.name == "first_use.launch"]
    assert launch.attr == "mg_kcycle_launch" and launch.parent == cap.id
    profiling.clear_spans()
    assert fill(card, seed=2)[1]["graph"] == "replayed"
    assert profiling.spans() == []
    # another key evicts it: both capture again, each a span
    fill(card, n=80)
    assert fill(card)[1]["graph"] == "captured"
    caps = [s for s in profiling.spans()
            if s.name == "first_use.graph_capture"]
    assert [c.attr["shape"] for c in caps] == [[80, 80], [96, 96]]
    profiling.clear_spans()


@pytest.mark.cuda
def test_the_cuda_library_load_records_its_hash_and_load(card, monkeypatch):
    _build.load()
    monkeypatch.setattr(_build, "load",
                        _build.load.__wrapped__)  # its body once more
    profiling.clear_spans()
    assert _build.load() is not None
    span, kids = library_tree()
    assert span.attr == {"library": "cuda", "built": False}
    assert kids == ["build.hash", "build.load"]
    profiling.clear_spans()
