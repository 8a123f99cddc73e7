"""smrf.fill_ms_per_call: the device's milliseconds in the springs fills
of one ``smrf`` call, from the CUDA events of the ``inpaint.springs``
spans (``ops/inpaint.py:_springs_core``: the multigrid hierarchy and the
preconditioned CG) under an ``smrf.call`` root, summed over the traced
window and divided by its calls."""

from portbench import program_spans as ps


def read(run):
    spans = ps.in_window(run)
    calls = ps.named(spans or [], "smrf.call")
    timed = [s.device_ms for s in ps.under(spans or [], "inpaint.springs",
                                           calls)
             if s.device_ms is not None]
    if not calls or not timed:
        return None
    return sum(timed) / len(calls)
