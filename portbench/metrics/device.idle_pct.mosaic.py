"""device.idle_pct.mosaic: ``device.idle_pct``'s arithmetic in the cells
that report ``mosaic_mpix_s``."""


def read(run):
    return None if run.trace is None else run.trace.idle_pct()
