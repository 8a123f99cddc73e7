"""job_p95_ms: the 95th percentile over all jobs of the window of one
job's wall, from the call to its outputs ready for the caller (numpy's
linear interpolation between order statistics)."""


def read(run):
    return run.p95_ms()
