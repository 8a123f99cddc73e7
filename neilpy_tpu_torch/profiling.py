"""Performance observability: throughput counters, device-trace capture,
spans inside the port and a first-call report.

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
  their ``__global__`` names.  The profiler itself sees only the thread
  that opened it; the trace adds the port's spans of every thread (the
  tile stream's producer and writer too), one track per thread.
* ``span`` — a named interval at a layer boundary of the port, recorded
  only while a ``torch.profiler`` profile is open in the process (by
  ``trace`` or by the caller): start and end on the clock of the
  profiler's events (``time.time_ns``), the thread, the parent span and
  the root span of the public call, optionally the device time between
  two CUDA events.  ``spans()`` reads the record, ``clear_spans()``
  empties it.  With no profile open a span is one shared null context.
* ``once`` — a span of the same record for work a process does once per
  key, recorded whether or not a profile is open: the package's import
  (``startup.import``), a library's hash, compile and load
  (``build.library`` and its children), a C entry's first launch
  (``first_launch``: ``first_use.launch``) and a CUDA graph's capture
  (``first_use.graph_capture``).  Never on a per-call path.
* ``compile_report`` — the seconds a first call spends building the
  port's libraries against the rest of that call.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.utils.flop_counter import FlopCounterMode

__all__ = ["Throughput", "sync", "trace", "compile_report", "span",
           "device_time", "once", "first_launch", "spans", "clear_spans"]


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


# ----------------------------------------------------------------------
# spans
# ----------------------------------------------------------------------
_NULL = contextlib.nullcontext()
_RECORD = []                 # closed spans, in the order they closed
_IDS = itertools.count(1)
_LOCAL = threading.local()   # .stack: the calling thread's open spans
_LAUNCHED = set()            # the C entries called in this process
_LAUNCHED_LOCK = threading.Lock()


def _open_spans():
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


# the profiler's event for a span on its own thread: the C++ record
# function, which keeps the interpreter lock and returns within a few
# microseconds of its stamps (``record_function`` releases the lock, so
# with other threads busy it returns up to hundreds of microseconds late)
_annotation = getattr(torch._C._profiler, "_RecordFunctionFast",
                      torch.profiler.record_function)


def _cuda_event(device):
    event = torch.cuda.Event(enable_timing=True)
    event.record(torch.cuda.current_stream(device))
    return event


class Span:
    """One span of the record (:func:`span`, :func:`once`): ``name``;
    ``start_ns`` and ``end_ns`` on ``time.time_ns``'s clock, the Unix clock
    of the profiler's own events; ``thread`` (the thread's name); ``id``;
    ``parent`` (the parent span's id, None for a root); ``root`` (the id
    of the root span, shared by every span of one public call); ``attr``
    (a detail, such as the C entry a launch called, or None); and
    ``device_ms``, the milliseconds between its pairs of CUDA events
    (None without any), filled in when :func:`spans` reads the record."""

    __slots__ = ("name", "id", "parent", "root", "thread", "attr",
                 "start_ns", "end_ns", "device_ms", "_device", "_events",
                 "_annotation")

    def __init__(self, name, parent, device, attr, start_ns=None):
        stack = _open_spans()
        if parent is None and stack:
            parent = stack[-1]
        self.name = name
        self.id = next(_IDS)
        self.parent = None if parent is None else parent.id
        self.root = self.id if parent is None else parent.root
        self.thread = threading.current_thread().name
        self.attr = attr
        self.start_ns = start_ns
        self.end_ns = self.device_ms = None
        self._device = device
        self._events = []        # CUDA events, a (start, end) pair each
        self._annotation = None

    def __enter__(self):
        _open_spans().append(self)
        if torch._C._autograd._profiler_enabled():
            # the profiler's own thread: the span is in its events too,
            # and the clock is read just after each of their stamps
            self._annotation = _annotation(self.name)
            self._annotation.__enter__()
        if self.start_ns is None:
            self.start_ns = time.time_ns()
        if self._device is not None:
            self._events.append(_cuda_event(self._device))
        return self

    def __exit__(self, *exc):
        if self._device is not None:
            self._events.append(_cuda_event(self._device))
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
            self._annotation = None
        _open_spans().pop()
        self.end_ns = time.time_ns()
        _RECORD.append(self)
        return False


def span(name, parent=None, device=None, attr=None):
    """A context manager that records the block as span ``name`` while a
    ``torch.profiler`` profile is open anywhere in the process (the
    process-wide flag, which every thread reads; the profiler records
    only the thread that opened it).  Otherwise it returns one shared
    null context and records, allocates and formats nothing, so ``name``
    is a constant string at every call site.

    The parent is ``parent`` (a span a caller's thread opened: worker
    threads pass their call's span), else the innermost span the calling
    thread has open; a span with neither is the root of a public call.
    On the profiler's own thread the span is also a record function of
    the same name (torch's C++ ``_RecordFunctionFast`` where it has one,
    else ``torch.profiler.record_function``), so it appears among the
    profiler's events and in exported traces.  ``device`` (a CUDA device;
    anything else is ignored) records a pair of timing events on its
    current stream around the block.  ``with span(...) as s`` binds the
    span, or None when nothing is recorded.  Work a process does once is
    a :func:`once` span, which records with no profile open."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
    if device is not None and torch.device(device).type != "cuda":
        device = None
    return Span(name, parent, device, attr)


def once(name, attr=None, start_ns=None):
    """A :class:`Span` of the record around work the process does once
    per key (a library's build and load, a C entry's first launch, a CUDA
    graph's capture, the package's import), recorded whether or not a
    profile is open: :func:`span`'s clock, parent and root rules, and on
    the profiler's own thread its record function.  ``start_ns`` (a
    ``time.time_ns()`` stamp) starts the span before its ``with``: the
    package stamps its import's first line before this module can be
    imported.  It allocates a span a call, so no per-call path opens one;
    :func:`first_launch` guards the launch sites."""
    return Span(name, None, None, attr, start_ns)


def first_launch(entry):
    """The span ``first_use.launch`` (:func:`once`, ``attr`` the entry)
    around the first call of C entry ``entry`` in the process, whose host
    wall takes the lazy load of the entry's kernels; for every later call
    one shared null context after a set-membership test."""
    if entry in _LAUNCHED:
        return _NULL
    with _LAUNCHED_LOCK:
        if entry in _LAUNCHED:
            return _NULL
        _LAUNCHED.add(entry)
    return once("first_use.launch", attr=entry)


class _DeviceTime:
    __slots__ = ("span", "device")

    def __init__(self, owner, device):
        self.span, self.device = owner, device

    def __enter__(self):
        self.span._events.append(_cuda_event(self.device))

    def __exit__(self, *exc):
        self.span._events.append(_cuda_event(self.device))
        return False


def device_time(device):
    """A context manager that records a pair of CUDA timing events on
    ``device``'s current stream around the block, whose milliseconds add
    to the ``device_ms`` of the calling thread's innermost open span: a
    span's device time over part of its block.  A shared null context
    when no profile is open, no span is, or ``device`` is not a CUDA
    device."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
    stack = getattr(_LOCAL, "stack", None)
    if not stack or torch.device(device).type != "cuda":
        return _NULL
    return _DeviceTime(stack[-1], device)


def spans():
    """The record: every span closed while a profile was open and every
    :func:`once` span, since the process started or the last
    :func:`clear_spans`, in the order they closed (a list of
    :class:`Span`).  Reading it resolves each span's
    CUDA events into ``device_ms``, waiting for them where the device
    has not reached them yet."""
    out = list(_RECORD)
    for s in out:
        if s._events:
            events, s._events = s._events, []
            ms = 0.0
            for a, b in zip(events[::2], events[1::2]):
                b.synchronize()
                ms += a.elapsed_time(b)
            s.device_ms = ms
    return out


def clear_spans():
    """Empty the record of spans."""
    _RECORD.clear()


def _add_spans(path, record):
    """Write the spans of ``record`` into the Chrome trace JSON at ``path``,
    one track per thread under the process ``neilpy_tpu_torch spans``,
    on the file's time origin (``baseTimeNanoseconds``, where it has
    one)."""
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    for s in record:
        args = {k: getattr(s, k) for k in ("id", "parent", "root", "attr",
                                           "device_ms")
                if getattr(s, k) is not None}
        doc["traceEvents"].append({
            "ph": "X", "cat": "span", "name": s.name,
            "pid": "neilpy_tpu_torch spans", "tid": s.thread,
            "ts": (s.start_ns - base) / 1e3,
            "dur": (s.end_ns - s.start_ns) / 1e3, "args": args})
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(log_dir="/tmp/neilpy_tpu_torch_trace"):
    """Capture a trace viewable in Perfetto / ``chrome://tracing``:

    >>> with trace("/tmp/tr"):
    ...     sync(smrf(x, y, z, 1, 18))

    Records CPU activity of the calling thread, and CUDA activity when
    CUDA is available (the card is synchronised before the profiler
    stops, so every kernel launched inside the block is in the trace).
    The record of spans is cleared on entry; the port's spans of every
    thread (``span``: the calling thread's, and those of the tile
    stream's producer and writer threads, which the profiler does not
    see) go into the same file, one track per thread.  On a normal exit
    it writes ``trace_<pid>_<ns>.json`` into ``log_dir`` (created); an
    exception raised inside the block propagates and writes nothing.
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    clear_spans()
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
        if cuda:
            torch.cuda.synchronize()
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    _add_spans(path, spans())


@functools.cache
def _counter_ready():
    """Run one op under a flop counter: the first in a process imports
    ``torch._dynamo`` (seconds), which no report should be charged."""
    with FlopCounterMode(display=False):
        torch.zeros(1).add_(1)


def _build_seconds():
    from . import _build, _host_build  # they import this module
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
