"""spline.kernel_sweep_pct: the share, in percent, of the traced window's
Thomas solves under an ``smrf.call`` root that ran as the hand-written
kernel (the ``path`` of the ``spline.thomas`` spans' ``attr`` reads
``cuda``; ``eager``, the per-row torch ops, counts against it).  A
program whose solves carry no ``path`` reads None."""

from portbench import program_spans as ps


def read(run):
    spans = ps.in_window(run)
    calls = ps.named(spans or [], "smrf.call")
    how = [s.attr["path"] for s in ps.under(spans or [], "spline.thomas",
                                            calls)
           if isinstance(s.attr, dict) and "path" in s.attr]
    if not how:
        return None
    return 100.0 * how.count("cuda") / len(how)
