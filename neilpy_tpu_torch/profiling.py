"""Performance observability: throughput counters, device-trace capture
and a first-call report.

Counterpart of ``neilpy_tpu/profiling.py`` on CUDA and
``torch.profiler``, with the same names and arguments:

* ``sync`` — wait for the work producing ``x``: every CUDA device that a
  tensor of ``x`` lives on is synchronised, all of its streams included
  (``tiled_apply``'s upload and download streams too).
* ``Throughput`` — a context manager that measures host wall time
  around device work, ended by ``sync`` of its ``result``, and reports
  Mpix/s / Mpts/s style rates.
* ``trace`` — wraps ``torch.profiler.profile`` (CPU activity, and CUDA
  activity where there is a card) and writes a Chrome / Perfetto trace
  JSON into its directory.  The hand kernels launch through ``ctypes``,
  outside torch's dispatcher, and show in it as CUDA kernel events under
  their ``__global__`` names.
* ``compile_report`` — the seconds a first call spends building the
  port's libraries against the rest of that call.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time

import torch
from torch.utils.flop_counter import FlopCounterMode

from . import _build, _host_build

__all__ = ["Throughput", "sync", "trace", "compile_report"]


def _tensors(x):
    """Every tensor of ``x``: a tensor, or tuples, lists and dicts of
    them, nested."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)


def sync(x):
    """Block until the device work producing ``x`` is done; return ``x``.
    Synchronises each CUDA device a tensor of ``x`` lives on (all its
    streams); CPU tensors, other values and ``None`` need no wait, and
    CUDA is never initialised for them."""
    for dev in {t.device for t in _tensors(x) if t.is_cuda}:
        torch.cuda.synchronize(dev)
    return x


class Throughput:
    """Measure items/second around device work.

    >>> with Throughput("geomorphons", items=Z.numel(), unit="pix") as tp:
    ...     tp.result = geomorphons(Z, cellsize=10, lookup_pixels=50)
    geomorphons: 1234.5 Mpix/s (6.8 ms for 8.4 Mpix)

    Assign the device output to ``tp.result`` so the exit-time sync
    charges all pending work to the measured interval.
    """

    def __init__(self, name, items, unit="pix", quiet=False):
        self.name = name
        self.items = int(items)
        self.unit = unit
        self.quiet = quiet
        self.result = None
        self.seconds = None
        self.rate = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            sync(self.result)
        self.seconds = time.perf_counter() - self._t0
        self.rate = self.items / self.seconds if self.seconds else 0.0
        if not self.quiet and exc_type is None:
            if self.rate >= 1e6:
                rate = f"{self.rate / 1e6:,.1f} M{self.unit}/s"
            else:
                rate = f"{self.rate / 1e3:,.1f} K{self.unit}/s"
            print(f"{self.name}: {rate} ({self.seconds * 1e3:.1f} ms "
                  f"for {self.items / 1e6:.2f} M{self.unit})")
        return False


@contextlib.contextmanager
def trace(log_dir="/tmp/neilpy_tpu_torch_trace"):
    """Capture a trace viewable in Perfetto / ``chrome://tracing``:

    >>> with trace("/tmp/tr"):
    ...     sync(smrf(x, y, z, 1, 18))

    Records CPU activity, and CUDA activity when CUDA is available (the
    card is synchronised before the profiler stops, so every kernel
    launched inside the block is in the trace).  On a normal exit it
    writes ``trace_<pid>_<ns>.json`` into ``log_dir`` (created); an
    exception raised inside the block propagates and writes nothing.
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@functools.cache
def _counter_ready():
    """Run one op under a flop counter: the first in a process imports
    ``torch._dynamo`` (seconds), which no report should be charged."""
    with FlopCounterMode(display=False):
        torch.zeros(1).add_(1)


def _build_seconds():
    return _build.BUILD_SECONDS + _host_build.BUILD_SECONDS


def compile_report(fn, *args, name=None, **kwargs):
    """Report what a first call of ``fn(*args, **kwargs)`` costs beyond
    its work.  Returns a dict (and prints a one-liner).

    The port has no lowering that stops short of running, so this calls
    ``fn`` once, ended by ``sync`` of its result.  ``compile_s`` is the
    seconds that call spent building the CUDA kernels (``_build.build``)
    and the host libraries (``_host_build.build``), 0.0 when they were
    built already; ``lower_s`` is the rest of the call.  ``flops`` is
    added where ``torch.utils.flop_counter`` counts any (convolutions,
    matrix products), and omitted otherwise.
    """
    name = name or getattr(fn, "__name__", "fn")
    _counter_ready()
    built = _build_seconds()
    counter = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    with counter:
        sync(fn(*args, **kwargs))
    t_total = time.perf_counter() - t0
    t_compile = _build_seconds() - built
    t_lower = t_total - t_compile
    report = {"name": name, "lower_s": t_lower, "compile_s": t_compile}
    flops = counter.get_total_flops()
    if flops:
        report["flops"] = float(flops)
    extra = f", {flops / 1e9:.2f} GFLOP" if flops else ""
    print(f"compile[{name}]: lower {t_lower:.2f}s, compile "
          f"{t_compile:.2f}s{extra}")
    return report
