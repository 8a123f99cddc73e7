"""openness.ladder_ms_per_call: the device's milliseconds in the ladder
kernel of one ``openness_pair`` or ``skyview_factor`` call, from the CUDA
events around each C entry's call (the ``device_ms`` of the
``cuda_scan.launch`` spans under a ``visibility.openness_pair`` or
``visibility.skyview_factor`` root), summed over the traced window and
divided by those calls, whatever kernel (K5/reduced, K2 or a later one)
the entry runs."""

from portbench import program_spans as ps

ROOTS = ("visibility.openness_pair", "visibility.skyview_factor")


def read(run):
    spans = ps.in_window(run) or []
    calls = [s for name in ROOTS for s in ps.named(spans, name)]
    timed = [s.device_ms for s in ps.under(spans, "cuda_scan.launch", calls)
             if s.device_ms is not None]
    if not calls or not timed:
        return None
    return sum(timed) / len(calls)
