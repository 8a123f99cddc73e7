"""smrf.host_pct: the share of the ``smrf`` calls' wall that the host
spends in its float64 legs: the grid frame and bins (``pointgrid.bin``)
and the points' inverse affine (``smrf.inverse_affine``), over the summed
``smrf.call`` spans of the traced window, in percent."""

from portbench import program_spans as ps


def read(run):
    spans = ps.in_window(run)
    calls = ps.named(spans or [], "smrf.call")
    wall = ps.seconds(calls)
    if wall <= 0:
        return None
    host = (ps.under(spans, "pointgrid.bin", calls)
            + ps.under(spans, "smrf.inverse_affine", calls))
    return 100.0 * ps.seconds(host) / wall
