"""mosaic.outside_loop_pct: the share of the mosaic calls' wall spent
outside the tile loop (the moments pass and each call's set-up), (call
wall - ``phase_stats['total']``) / call wall, summed over the window's
jobs (a job is one call)."""


def read(run):
    wall = sum(b - a for a, b in run.jobs)
    total = run.counters.get("total", 0.0)
    if wall <= 0 or total <= 0:
        return None
    return 100.0 * (wall - total) / wall
