"""dem_products.host_ms_per_job: the host's time in one job's three
public calls (the root spans ``surface.hillshade``,
``surface.esri_curvature`` and ``stats.shi_landslides``: the checks and
every torch op's enqueue; the device runs on after they return), summed
over the traced window and divided by its jobs, in milliseconds.  The
spans' own cost while tracing is in it."""

from portbench import program_spans as ps

ROOTS = ("surface.hillshade", "surface.esri_curvature",
         "stats.shi_landslides")


def read(run):
    spans = ps.in_window(run) or []
    calls = [s for name in ROOTS for s in ps.named(spans, name)
             if s.parent is None]
    if not calls or not run.trace.jobs:
        return None
    return 1e3 * ps.seconds(calls) / len(run.trace.jobs)
