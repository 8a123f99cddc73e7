"""dem_products.curvature_ms_per_job: the device's milliseconds in the
surface stencils of one job, from the CUDA events of the
``surface.esri_curvature`` and ``surface.evans_curvature`` spans (the
latter under ``stats.shi_landslides``), summed over the traced window
and divided by its jobs."""

from portbench import program_spans as ps

NAMES = ("surface.esri_curvature", "surface.evans_curvature")


def read(run):
    spans = ps.in_window(run) or []
    timed = [s.device_ms for name in NAMES for s in ps.named(spans, name)
             if s.device_ms is not None]
    if not timed or not run.trace.jobs:
        return None
    return sum(timed) / len(run.trace.jobs)
