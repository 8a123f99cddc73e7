"""setup.library_s: the seconds the run's process spends finding,
building and loading the port's libraries before the traced window: the
``build.library`` spans (the CUDA library's ``_build.load``, each host
library's ``_host_build.load``: hash, compile where it ran, load and
declarations), which the port records whether or not a profile is open
(``profiling.once``).  A program that records no such span (one without
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
    spans = [s for s in spans or [] if s.name == "build.library"]
    if not spans:
        return None
    return sum(s.end_ns - s.start_ns for s in spans) / 1e9
