"""setup.import_s: the seconds of ``import neilpy_tpu_torch`` in the run's
process, from the first line of the package's ``__init__.py`` to its last:
the ``startup.import`` span, which the port records whether or not a
profile is open (``profiling.once``), where it ends before the traced
window.  A program that records no such span (one without
``profiling.once``) gives None."""


def _before_window(run):
    """The spans of the record that end before the window opens, or None
    without a trace or where the program records no spans."""
    if run.trace is None:
        return None
    from neilpy_tpu_torch import profiling
    read = getattr(profiling, "spans", None)
    if read is None:
        return None
    return [s for s in read() if s.end_ns < run.trace.window[0]]


def read(run):
    spans = _before_window(run)
    spans = [s for s in spans or [] if s.name == "startup.import"]
    if not spans:
        return None
    return sum(s.end_ns - s.start_ns for s in spans) / 1e9
