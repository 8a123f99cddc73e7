"""mosaic.moments_pct: the share of the mosaic calls' wall spent in the
moments pass, from the program's spans: the summed ``mosaic.moments``
(``pipelines/mosaic.py:_global_moments``, its sidecar read included)
over the summed ``mosaic.call`` (the whole public call) in the traced
window, in percent."""

from portbench import program_spans as ps


def read(run):
    spans = ps.in_window(run)
    if not spans:
        return None
    wall = ps.seconds(ps.named(spans, "mosaic.call"))
    if wall <= 0:
        return None
    return 100.0 * ps.seconds(ps.named(spans, "mosaic.moments")) / wall
