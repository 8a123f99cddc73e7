"""transfer.copy_ms_per_job: milliseconds of the device's copies
(the profiler's Memcpy spans: host to device and back) per job of the
traced window."""


def read(run):
    if run.trace is None or not run.trace.jobs:
        return None
    copy_s = run.trace.copy_s()
    if copy_s <= 0:
        return None
    return 1e3 * copy_s / len(run.trace.jobs)
