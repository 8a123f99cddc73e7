"""inpaint.kcycle_kernel_pct: the share, in percent, of the traced
window's springs fills under an ``smrf.call`` root whose multigrid
K-cycle ran as the hand-written kernels (the ``kcycle`` of the
``inpaint.springs`` spans' ``attr`` reads ``cuda``; ``torch``, the plain
torch ops, counts against it; a fill without a K-cycle, whose ``kcycle``
is None, counts for neither).  A program whose fills carry no
``kcycle`` reads None."""

from portbench import program_spans as ps


def read(run):
    spans = ps.in_window(run)
    calls = ps.named(spans or [], "smrf.call")
    how = [s.attr["kcycle"] for s in ps.under(spans or [], "inpaint.springs",
                                              calls)
           if isinstance(s.attr, dict) and s.attr.get("kcycle")]
    if not how:
        return None
    return 100.0 * how.count("cuda") / len(how)
