"""device.idle_pct.host: ``device.idle_pct``'s arithmetic in the cells
that report ``raster_mpix_s.host`` (the profiler counts the copies as
busy time)."""


def read(run):
    return None if run.trace is None else run.trace.idle_pct()
