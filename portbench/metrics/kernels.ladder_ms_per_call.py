"""kernels.ladder_ms_per_call: the device's milliseconds in the ladder
kernels of one ``geomorphons`` call, from the CUDA events around each C
entry's call (the ``device_ms`` of the ``cuda_scan.launch`` spans under a
``visibility.geomorphons`` root), summed over the traced window and
divided by its calls, whatever kernel (K5, K1 or a later one) the entry
runs."""

from portbench import program_spans as ps


def read(run):
    spans = ps.in_window(run)
    calls = ps.named(spans or [], "visibility.geomorphons")
    timed = [s.device_ms for s in ps.under(spans or [], "cuda_scan.launch",
                                           calls)
             if s.device_ms is not None]
    if not calls or not timed:
        return None
    return sum(timed) / len(calls)
