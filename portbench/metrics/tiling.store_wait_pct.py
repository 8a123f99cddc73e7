"""tiling.store_wait_pct: the tile stream's writer backpressure,
``phase_stats['store_wait'] / phase_stats['total']`` of
``dist/tiling.py:tiled_apply``, each summed over the window's calls."""


def read(run):
    total = run.counters.get("total", 0.0)
    if total <= 0:
        return None
    return 100.0 * run.counters.get("store_wait", 0.0) / total
