"""device.idle_pct.smrf: ``device.idle_pct``'s arithmetic in the SMRF
cells (the profiler counts the copies as busy time)."""


def read(run):
    return None if run.trace is None else run.trace.idle_pct()
