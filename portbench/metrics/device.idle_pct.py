"""device.idle_pct: the share of the traced window (first job's start to
last job's end) in which no kernel, copy or fill ran on the device, from
the union of the profiler's CUDA spans (``chip_smoke.py:device_profile``),
in the cells that report ``raster_mpix_s``."""


def read(run):
    return None if run.trace is None else run.trace.idle_pct()
