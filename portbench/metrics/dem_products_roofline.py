"""dem_products_roofline: the least time one job's work could take on the
card, max(operations / PEAK_F32_OPS, bytes / PEAK_HBM_BYTES)
(``systems/dem_products.py:dem_work``: the footprint sums of both radii
at a sliding window's add and subtract a footprint row, and the three
products' elementwise formulas; the DEM read once a call and each output
written once), over the device-busy time inside each job's span (the
union of its CUDA spans: every kernel the calls launch, whatever
implements it), summed over the traced window, in percent of the
published peaks: ``openness_roofline``'s arithmetic."""

from portbench.roofline import bound_seconds


def read(run):
    if run.trace is None or run.work is None:
        return None
    busy = sum(run.trace.busy_per_job())
    if busy <= 0:
        return None
    least, _ = bound_seconds(run.work["ops"], run.work["bytes"])
    return 100.0 * least * len(run.trace.jobs) / busy
