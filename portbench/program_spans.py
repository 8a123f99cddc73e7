"""The port's own spans (``neilpy_tpu_torch.profiling.span``) inside a
traced run's window, for the readers of the ``program_span`` metrics.

A span's edges are Unix nanoseconds (``time.time_ns``), the clock of the
profiler's events and so of ``trace.Record``'s window and busy
intervals.  A program without spans (no ``profiling.spans``) gives None,
as a run without a trace does."""

from __future__ import annotations


def in_window(run):
    """The spans the program recorded inside ``run.trace.window``, or None
    without a trace or where the program records none."""
    if run.trace is None:
        return None
    from neilpy_tpu_torch import profiling
    read = getattr(profiling, "spans", None)
    if read is None:
        return None
    lo, hi = run.trace.window
    return [s for s in read() if lo <= s.start_ns and s.end_ns <= hi]


def named(spans, name):
    return [s for s in spans if s.name == name]


def seconds(spans):
    """The spans' summed durations, in seconds."""
    return sum(s.end_ns - s.start_ns for s in spans) / 1e9


def under(spans, name, roots):
    """The spans called ``name`` whose root span is one of ``roots``."""
    ids = {r.id for r in roots}
    return [s for s in spans if s.name == name and s.root in ids]
