"""setup.first_use_s: the seconds the run's process spends in first uses
before the traced window: each C entry's first call
(``first_use.launch``, whose host wall takes the lazy load of its
kernels) and each CUDA graph capture (``first_use.graph_capture``), which
the port records whether or not a profile is open (``profiling.once``).
A first launch inside a capture is counted once, with the capture, and a
library load inside a first use is left to ``setup.library_s``.  A
program that records no such span (one without ``profiling.once``) gives
None."""


def _before_window(run):
    """(every span of the record by id, those that end before the
    window), or None without a trace or where the program records no
    spans."""
    if run.trace is None:
        return None
    from neilpy_tpu_torch import profiling
    read = getattr(profiling, "spans", None)
    if read is None:
        return None
    record = read()
    return ({s.id: s for s in record},
            [s for s in record if s.end_ns < run.trace.window[0]])


def _enclosed(s, by_id, kind):
    """Whether a span whose name ``kind`` accepts encloses ``s`` (its
    parents followed through ``by_id``)."""
    p = by_id.get(s.parent)
    while p is not None and not kind(p.name):
        p = by_id.get(p.parent)
    return p is not None


def _outermost(spans, by_id, kind):
    """The spans of ``spans`` whose name ``kind`` accepts and that no span
    of the same kind encloses."""
    return [s for s in spans
            if kind(s.name) and not _enclosed(s, by_id, kind)]


def _first_use(name):
    return name.startswith("first_use.")


def read(run):
    found = _before_window(run)
    if found is None:
        return None
    by_id, before = found
    uses = _outermost(before, by_id, _first_use)
    if not uses:
        return None
    # a library load inside a first use (the CUDA library's, in the first
    # graph capture of an SMRF process) belongs to setup.library_s
    loads = [s for s in _outermost(before, by_id,
                                   lambda n: n == "build.library")
             if _enclosed(s, by_id, _first_use)]
    return (sum(s.end_ns - s.start_ns for s in uses)
            - sum(s.end_ns - s.start_ns for s in loads)) / 1e9
