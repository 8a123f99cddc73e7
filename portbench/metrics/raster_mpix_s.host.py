"""raster_mpix_s.host: ``raster_mpix_s``'s arithmetic in the cells whose
DEMs and classes cross between host and card in every job, bound by the
host's pageable copies, which spread far wider than the kernel-bound
cells and need a bound of their own (PERF.md §2)."""


def read(run):
    return run.mpix_s()
