"""dem_products.launches_per_job: the device's kernels (the profiler's
CUDA spans less the copies and fills, ``Memcpy`` / ``Memset``) that start
inside each job span of the traced window, the mean over its jobs, as
``smrf.launches_per_job`` counts them.  None where the trace holds no
kernel at all (no card)."""

import bisect


def read(run):
    if run.trace is None or not run.trace.jobs:
        return None
    starts = [a for name, a, _ in run.trace.device
              if not name.startswith(("Memcpy", "Memset"))]
    if not starts:
        return None
    counts = [bisect.bisect_right(starts, b) - bisect.bisect_left(starts, a)
              for a, b in run.trace.jobs]
    return sum(counts) / len(counts)
