"""openness_roofline: the least time one job's work could take on the
card, max(operations / PEAK_F32_OPS, bytes / PEAK_HBM_BYTES)
(``systems/openness_l50.py:relief_work``: an ``openness_pair`` and a
``skyview_factor`` call, their operations per ladder step of the exact
ladder plus K2's fold over 8 directions a pixel, the DEM read once a call
and the three outputs written once), over the device-busy time inside
each job's span (the union of its CUDA spans: every kernel the calls
launch, whatever implements it), summed over the traced window, in
percent of the published peaks: ``geomorphons_roofline``'s arithmetic."""

from portbench.roofline import bound_seconds


def read(run):
    if run.trace is None or run.work is None:
        return None
    busy = sum(run.trace.busy_per_job())
    if busy <= 0:
        return None
    least, _ = bound_seconds(run.work["ops"], run.work["bytes"])
    return 100.0 * least * len(run.trace.jobs) / busy
