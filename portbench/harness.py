"""One run of one cell: everything ``run.py`` does after its checks.

The cell's files are found by name: ``BENCHMARK.json`` names the cell's
configuration (its ``file``) and traffic; ``systems/<config>.py`` drives
the port for that configuration, ``reference/<config>.py`` is its plain
reference, ``traffic/<traffic>.json`` its traffic mix and
``metrics/<metric>.py`` the reader of each metric.  Adding any of them
takes new files and entries only.

A run: the system module makes the inputs from the seed and warms up
(set-up), then a closed loop with one caller runs jobs until ``seconds`` have
passed (the job in flight at the deadline is finished and counted), the
device's peak memory is read, and the outputs the timed path produced are
judged against the reference (``correct``).  With ``trace`` the window
runs under ``torch.profiler`` and the per-layer metrics are read from it;
without, the end-to-end metrics.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import trace as trace_mod

BASE = Path(__file__).resolve().parent
ROOT = BASE.parent
BANNED = ("jax", "jaxlib", "flax", "neilpy_tpu")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path, name):
    """Import the file ``path`` as module ``name`` (names may hold dots,
    so files are loaded by path)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def banned_modules():
    """Top-level names in ``sys.modules`` that a run may not load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


class CellSpec:
    """A cell of the manifest with its files, found by name."""

    def __init__(self, name, manifest=None, base=BASE):
        self.base = Path(base)
        root = self.base.parent
        self.manifest = load_json(manifest or root / "BENCHMARK.json")
        cells = {w["name"]: w for w in self.manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.entry = cells[name]
        self.name = name
        configs = {c["name"]: c for c in self.manifest["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = load_json(root / self.config_entry["file"])
        self.traffic = load_json(self.base / "traffic"
                                 / f"{self.entry['traffic']}.json")
        cfg = self.entry["config"]
        self.system_path = self.base / "systems" / f"{cfg}.py"
        self.reference_path = self.base / "reference" / f"{cfg}.py"

    def metrics(self, kind):
        """The manifest's ``kind`` metrics (``end_to_end`` / ``per_layer``)
        this cell reports."""
        return [m for m in self.manifest[kind]
                if self.name in m.get("workloads", [self.name])]

    def metric_path(self, name):
        return self.base / "metrics" / f"{name}.py"

    def system(self):
        return load_module(self.system_path,
                           f"portbench.systems.{self.entry['config']}")

    def reference(self):
        return load_module(self.reference_path,
                           f"portbench.reference.{self.entry['config']}")


class Run:
    """What a metric's reader reads (``read(run) -> number or None``):
    ``jobs`` (host-clock start, end of each job in the window, seconds),
    ``window_s``, ``setup_s``, ``pixels_per_job``, ``counters`` (the
    program's counters summed over the window), ``work`` (one job's
    operations and bytes, or None), ``trace`` (a ``trace.Record`` in a
    traced run, else None) and the cell's ``config`` and ``traffic``."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def mpix_s(self):
        """Input pixels of every job in the window over the whole window,
        in millions per second."""
        if not self.jobs:
            return None
        return len(self.jobs) * self.pixels_per_job / self.window_s / 1e6

    def p95_ms(self):
        """The 95th percentile over the window's jobs of one job's wall,
        in milliseconds (numpy's linear interpolation)."""
        if not self.jobs:
            return None
        return float(np.percentile([(b - a) * 1e3 for a, b in self.jobs],
                                   95))


def spans(tracing):
    """``span(name)``: a ``record_function`` named ``portbench.<name>``
    when tracing, else nothing."""
    if not tracing:
        return lambda name: contextlib.nullcontext()
    return lambda name: torch.profiler.record_function(
        trace_mod.PREFIX + name)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _profiler(tracing):
    if not tracing:
        return contextlib.nullcontext()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def prepare(name, seed, device, manifest=None, base=BASE, overrides=None):
    """(cell, config, traffic, system): the cell's files with
    ``overrides`` ({"config": {...}, "traffic": {...}}, for tests) and its
    system module's ``Cell``, which makes the inputs from ``seed`` on
    ``device``."""
    cell = CellSpec(name, manifest, base)
    config = {**cell.config, **(overrides or {}).get("config", {})}
    traffic = {**cell.traffic, **(overrides or {}).get("traffic", {})}
    return cell, config, traffic, cell.system().Cell(config, traffic, seed,
                                                      device)


def closed_loop(dut, seconds, span):
    """Jobs of one caller until ``seconds`` have passed, the last one
    finished: ([(start, end)], [what each job returned])."""
    jobs, info = [], []
    deadline = time.perf_counter() + seconds
    k = 0
    while time.perf_counter() < deadline:
        t0 = time.perf_counter()
        with span("job"):
            info.append(dut.job(k, span))
        jobs.append((t0, time.perf_counter()))
        k += 1
    return jobs, info


def run_cell(name, seed, seconds, tracing, device, t_start,
             manifest=None, base=BASE, overrides=None, log=print):
    """Run cell ``name``; return the result line's object (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, ``breakdown``,
    ``checks``).  ``overrides`` ({"config": {...}, "traffic": {...}})
    changes the sizes (tests); ``t_start`` is the process's start on the
    host clock."""
    cell, config, traffic, dut = prepare(name, seed, device, manifest, base,
                                         overrides)
    limits = config["limits"]
    span = spans(tracing)
    try:
        from neilpy_tpu_torch import _build
        built = _build.BUILD_SECONDS
        dut.warm(span)
        _sync(device)
        compile_s = _build.BUILD_SECONDS - built
        if tracing:
            # the profiler's first window in a process carries its
            # start-up: a small one here, in the set-up
            with _profiler(True):
                torch.ones(1, device=device).add_(1)
                _sync(device)
        cuda = torch.device(device).type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        t_win = time.perf_counter()
        setup_s = t_win - t_start
        with _profiler(tracing) as prof:
            jobs, info = closed_loop(dut, seconds, span)
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        window_s = jobs[-1][1] - t_win
        record = trace_mod.Record(prof, info) if tracing else None
        run = Run(jobs=jobs, window_s=window_s, setup_s=setup_s,
                  pixels_per_job=dut.pixels_per_job,
                  counters=dut.counters(), work=dut.work(), trace=record,
                  config=config, traffic=traffic)
        metrics = {}
        for m in cell.metrics("per_layer" if tracing else "end_to_end"):
            reader = load_module(cell.metric_path(m["name"]),
                                 f"portbench.metrics.{m['name']}")
            value = reader.read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        # the program's state goes before the reference runs
        if cuda:
            torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        numbers, failed = dut.judge(cell.reference(), limits)
        log(f"reference and judgement {time.perf_counter() - t_ref:.1f} s",
            file=sys.stderr)
    finally:
        dut.close()
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": int(cell.entry["chips"]),
           "memory_peak_bytes": int(peak)}
    out = {"correct": all(v <= limits[k] for k, v in numbers.items()),
           "attempted": len(jobs), "failed": int(failed),
           "metrics": metrics, "device": dev,
           "setup": {"setup_s": setup_s, "compile_s": compile_s}}
    if tracing:
        dev["busy_s"] = record.busy_s()
        dev["window_s"] = record.window_s()
        out["breakdown"] = record.breakdown()
    out["checks"] = checks
    return out
