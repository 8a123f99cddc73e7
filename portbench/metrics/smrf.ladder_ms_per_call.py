"""smrf.ladder_ms_per_call: the device's milliseconds in the opening
ladder of one ``smrf`` call (``pipelines/smrf.py:_progressive_ladder``,
the disk erosions and dilations of every window), from the CUDA events
of the ``smrf.ladder`` spans under an ``smrf.call`` root, summed over
the traced window and divided by its calls."""

from portbench import program_spans as ps


def read(run):
    spans = ps.in_window(run)
    calls = ps.named(spans or [], "smrf.call")
    timed = [s.device_ms for s in ps.under(spans or [], "smrf.ladder", calls)
             if s.device_ms is not None]
    if not calls or not timed:
        return None
    return sum(timed) / len(calls)
