"""inpaint.cg_iters_per_fill: the conjugate-gradient iterations of one
springs fill of an ``smrf`` call (the ``iterations`` of the
``inpaint.springs`` spans' ``attr``, what ``return_info`` reports) under
an ``smrf.call`` root, the mean over the traced window's fills."""

from portbench import program_spans as ps


def read(run):
    spans = ps.in_window(run)
    calls = ps.named(spans or [], "smrf.call")
    its = [s.attr["iterations"] for s in ps.under(spans or [],
                                                  "inpaint.springs", calls)
           if isinstance(s.attr, dict) and "iterations" in s.attr]
    if not its:
        return None
    return sum(its) / len(its)
