"""tiling.loop_idle_pct: the share of the tile loops' wall (the
``tiling.loop`` spans, ``phase_stats['total']``'s interval) in which no
kernel, copy or fill ran on the device, from the union of the profiler's
CUDA spans (``trace.busy_in``), in percent."""

from portbench import program_spans as ps
from portbench.trace import busy_in


def read(run):
    spans = ps.in_window(run)
    loops = ps.named(spans or [], "tiling.loop")
    wall = ps.seconds(loops)
    if wall <= 0:
        return None
    starts = [a for a, _ in run.trace.busy]
    busy = sum(busy_in(run.trace.busy, s.start_ns, s.end_ns, starts)
               for s in loops) / 1e9
    return 100.0 * (1.0 - busy / wall)
