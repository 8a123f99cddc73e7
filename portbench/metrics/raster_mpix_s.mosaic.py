"""raster_mpix_s.mosaic: ``raster_mpix_s``'s arithmetic (input DEM
pixels of every call completed in the window over the whole window) in
the mosaic's cells, a metric of its own because those cells are bound by
the host's CPU and spread far wider than the kernel-bound ones, so they
need a bound of their own (PERF.md §2)."""


def read(run):
    return run.mpix_s()
