"""cuda_scan.launch_host_us: the host's time in one kernel launch of
``ops/cuda_scan.py:_launch`` (the ``cuda_scan.launch`` span: the ladder
tables, the tile route, the region plan, the C entry's call), the mean
over the traced window's launches, in microseconds.  The spans' own cost
while tracing is in it."""

from portbench import program_spans as ps


def read(run):
    spans = ps.in_window(run)
    launches = ps.named(spans or [], "cuda_scan.launch")
    if not launches:
        return None
    return 1e6 * ps.seconds(launches) / len(launches)
