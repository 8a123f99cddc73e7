"""openness.host_ms_per_call: the host's time in one public
``openness_pair`` or ``skyview_factor`` call (the
``visibility.openness_pair`` and ``visibility.skyview_factor`` spans:
the raster's checks, the launch's tables, route and plan, the epilogue's
enqueue; the device runs on after it returns), the mean over the traced
window's calls, in milliseconds.  The spans' own cost while tracing is
in it."""

from portbench import program_spans as ps

ROOTS = ("visibility.openness_pair", "visibility.skyview_factor")


def read(run):
    spans = ps.in_window(run) or []
    calls = [s for name in ROOTS for s in ps.named(spans, name)]
    if not calls:
        return None
    return 1e3 * ps.seconds(calls) / len(calls)
