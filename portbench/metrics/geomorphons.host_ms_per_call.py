"""geomorphons.host_ms_per_call: the host's time in one public
``geomorphons`` call (the ``visibility.geomorphons`` span: input checks,
the launch's tables, route and plan, the class gather's enqueue; the
device runs on after it returns), the mean over the traced window's
calls, in milliseconds.  The spans' own cost while tracing is in it."""

from portbench import program_spans as ps


def read(run):
    spans = ps.in_window(run)
    calls = ps.named(spans or [], "visibility.geomorphons")
    if not calls:
        return None
    return 1e3 * ps.seconds(calls) / len(calls)
