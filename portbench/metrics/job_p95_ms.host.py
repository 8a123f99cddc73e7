"""job_p95_ms.host: ``job_p95_ms``'s arithmetic in the cells that report
``raster_mpix_s.host``."""


def read(run):
    return run.p95_ms()
