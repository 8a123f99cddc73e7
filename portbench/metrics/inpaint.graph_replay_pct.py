"""inpaint.graph_replay_pct: the share, in percent, of the traced window's
springs fills under an ``smrf.call`` root that replayed CUDA graphs
captured earlier (the ``graph`` of the ``inpaint.springs`` spans'
``attr`` reads ``replayed``; ``captured`` and ``eager`` count against
it).  A program whose fills carry no ``graph`` reads None."""

from portbench import program_spans as ps


def read(run):
    spans = ps.in_window(run)
    calls = ps.named(spans or [], "smrf.call")
    how = [s.attr["graph"] for s in ps.under(spans or [], "inpaint.springs",
                                             calls)
           if isinstance(s.attr, dict) and "graph" in s.attr]
    if not how:
        return None
    return 100.0 * how.count("replayed") / len(how)
