"""smrf.spline_ms_per_call: the device's milliseconds in the spline
coefficients of one ``smrf`` call (``pipelines/smrf.py:_smrf_raster``:
two ``spline_coefficients_2d`` sets, six Thomas solves, and the slope
between them), from the CUDA events of the ``smrf.spline`` spans under
an ``smrf.call`` root, summed over the traced window and divided by its
calls."""

from portbench import program_spans as ps


def read(run):
    spans = ps.in_window(run)
    calls = ps.named(spans or [], "smrf.call")
    timed = [s.device_ms for s in ps.under(spans or [], "smrf.spline", calls)
             if s.device_ms is not None]
    if not calls or not timed:
        return None
    return sum(timed) / len(calls)
