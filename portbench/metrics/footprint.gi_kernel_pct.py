"""footprint.gi_kernel_pct: the share, in percent, of the traced window's
``stats.rasterGi`` spans whose footprint sums and z / p / bin epilogue
ran as the hand-written kernel (the ``path`` of the span's ``attr``
reads ``cuda``; ``torch``, the plain torch ops, counts against it).  A
program whose Gi* spans carry no ``path`` reads None."""

from portbench import program_spans as ps


def read(run):
    spans = ps.in_window(run) or []
    how = [s.attr["path"] for s in ps.named(spans, "stats.rasterGi")
           if isinstance(s.attr, dict) and s.attr.get("path")]
    if not how:
        return None
    return 100.0 * how.count("cuda") / len(how)
