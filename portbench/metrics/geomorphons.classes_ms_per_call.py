"""geomorphons.classes_ms_per_call: the device's milliseconds in the
class epilogue of one ``geomorphons`` call, from the CUDA events around
``visibility.classes_from_counts`` (its table copy and gather) under a
``visibility.geomorphons`` root, summed over the traced window and
divided by its calls: a call without that span (an epilogue fused into
the counts kernel) adds 0."""

from portbench import program_spans as ps


def read(run):
    spans = ps.in_window(run)
    calls = ps.named(spans or [], "visibility.geomorphons")
    if not calls:
        return None
    epilogue = ps.under(spans, "visibility.classes_from_counts", calls)
    return sum(s.device_ms or 0.0 for s in epilogue) / len(calls)
