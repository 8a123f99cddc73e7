"""geomorphons_roofline: the least time one ``geomorphons`` call's work
could take on the card, max(operations / PEAK_F32_OPS, bytes /
PEAK_HBM_BYTES) (``roofline.py``: 4 operations per ladder step of the
call's ladder, the DEM read once and the classes written once), over the
device-busy time inside each job's span (the union of its CUDA spans:
every kernel the call launches, whatever implements it), summed over the
traced window, in percent of the published peaks."""

from portbench.roofline import bound_seconds


def read(run):
    if run.trace is None or run.work is None:
        return None
    busy = sum(run.trace.busy_per_job())
    if busy <= 0:
        return None
    least, _ = bound_seconds(run.work["ops"], run.work["bytes"])
    return 100.0 * least * len(run.trace.jobs) / busy
