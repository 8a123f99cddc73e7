"""dem_products.gi_ms_per_job: the device's milliseconds in the Gi*
footprint statistics of one job, from the CUDA events of the
``stats.rasterGi`` spans (both radii of ``shi_landslides``), summed over
the traced window and divided by its jobs."""

from portbench import program_spans as ps


def read(run):
    spans = ps.in_window(run) or []
    timed = [s.device_ms for s in ps.named(spans, "stats.rasterGi")
             if s.device_ms is not None]
    if not timed or not run.trace.jobs:
        return None
    return sum(timed) / len(run.trace.jobs)
