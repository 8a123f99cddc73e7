"""Reduction of one ``torch.profiler`` window (CPU and CUDA activity) to
what the per-layer readers and the result's ``breakdown`` need.

The device's work is the union of its kernels', copies' and fills'
spans (``chip_smoke.py:device_profile``'s arithmetic); the host's side is
the harness's own ``record_function`` spans (``portbench.<name>``): one
``job`` span per job of the closed loop, with the phases the cell's
system module marks inside it (``call``, ``sync``, ``readback``, ``poison``).
"""

from __future__ import annotations

import bisect
import collections

import torch

PREFIX = "portbench."


def events(prof):
    """(device, annotations): device spans ``(name, start_ns, end_ns)``
    and the harness's spans ``(name, start_ns, end_ns)`` without the
    prefix, each sorted by start."""
    device, spans = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation() and not name.startswith(PREFIX):
                device.append((name, e.start_ns(),
                               e.start_ns() + e.duration_ns()))
        elif e.is_user_annotation() and name.startswith(PREFIX):
            spans.append((name[len(PREFIX):], e.start_ns(),
                          e.start_ns() + e.duration_ns()))
    return sorted(device, key=lambda s: s[1]), sorted(spans,
                                                      key=lambda s: s[1])


def union(device):
    """The device's busy intervals: the union of ``device``'s spans."""
    out = []
    for _, a, b in device:
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def busy_in(busy, a, b, starts=None):
    """Nanoseconds of the intervals ``busy`` (``starts`` their starts)
    inside [a, b]."""
    if starts is None:
        starts = [s for s, _ in busy]
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    total = 0
    while i < len(busy) and busy[i][0] < b:
        total += max(0, min(b, busy[i][1]) - max(a, busy[i][0]))
        i += 1
    return total


class Record:
    """The traced window: ``jobs`` (start_ns, end_ns) from the ``job``
    spans, ``children`` each job's inner spans, ``busy`` the device's
    busy intervals, ``device`` its spans, ``window`` (first job start,
    last job end)."""

    def __init__(self, prof, job_info):
        self.device, spans = events(prof)
        self.busy = union(self.device)
        self._busy_starts = [a for a, _ in self.busy]
        self.jobs = [(a, b) for name, a, b in spans if name == "job"]
        self._job_starts = starts = [a for a, _ in self.jobs]
        self.children = [[] for _ in self.jobs]
        for name, a, b in spans:
            if name == "job":
                continue
            j = bisect.bisect_right(starts, a) - 1
            if 0 <= j < len(self.jobs) and a <= self.jobs[j][1]:
                self.children[j].append((name, a, b))
        # a system module may split its call span in two at a program
        # counter: (first label, second label, seconds of the second part)
        for j, info in enumerate(job_info[:len(self.jobs)]):
            split = (info or {}).get("split")
            if not split:
                continue
            first, second, secs = split
            kids = []
            for name, a, b in self.children[j]:
                if name == "call":
                    cut = max(a, b - round(secs * 1e9))
                    kids += [(f"call/{first}", a, cut),
                             (f"call/{second}", cut, b)]
                else:
                    kids.append((name, a, b))
            self.children[j] = kids
        self.window = ((self.jobs[0][0], self.jobs[-1][1]) if self.jobs
                       else (0, 0))

    def window_s(self):
        return (self.window[1] - self.window[0]) / 1e9

    def busy_s(self):
        return busy_in(self.busy, *self.window, self._busy_starts) / 1e9

    def idle_pct(self):
        """The share of the window in which no kernel, copy or fill ran
        on the device, in percent."""
        if self.window_s() <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s() / self.window_s())

    def busy_per_job(self):
        """Device-busy seconds inside each job span."""
        return [busy_in(self.busy, a, b, self._busy_starts) / 1e9
                for a, b in self.jobs]

    def copy_s(self):
        """Seconds of the device's copies (Memcpy spans) in the window."""
        lo, hi = self.window
        return sum(min(b, hi) - max(a, lo) for name, a, b in self.device
                   if name.startswith("Memcpy") and b > lo and a < hi) / 1e9

    def segments(self):
        """(label, start, end) pieces that tile the window in time order:
        ``job/<span>`` inside a job's inner span, ``job/other`` in a job
        outside them, ``between jobs`` outside every job."""
        segs, prev = [], self.window[0]
        for (a, b), kids in zip(self.jobs, self.children):
            if a > prev:
                segs.append(("between jobs", prev, a))
            t = a
            for name, ca, cb in sorted(kids, key=lambda k: k[1]):
                ca, cb = max(ca, t), min(cb, b)
                if ca > t:
                    segs.append(("job/other", t, ca))
                if cb > ca:
                    segs.append((f"job/{name}", ca, cb))
                    t = cb
            if b > t:
                segs.append(("job/other", t, b))
            prev = max(prev, b)
        return segs

    def breakdown(self, top=10):
        """``device_ops``: the device operations that took most time,
        summed by name; ``idle_gaps``: the device's idle time in the
        window summed by what the host was doing then (the innermost
        harness span, ``segments``)."""
        ops = collections.Counter()
        for name, a, b in self.device:
            ops[name[:200]] += (b - a) / 1e9
        idle = collections.Counter()
        lo, hi = self.window
        edges = [lo] + [x for a, b in self.busy for x in (a, b)] + [hi]
        gaps = [(max(a, lo), min(b, hi))
                for a, b in zip(edges[::2], edges[1::2])]
        gaps = [(a, b) for a, b in gaps if b > a]
        segs = self.segments()
        i = 0
        for a, b in gaps:
            while i < len(segs) and segs[i][2] <= a:
                i += 1
            k = i
            while k < len(segs) and segs[k][1] < b:
                name, sa, sb = segs[k]
                idle[name] += max(0, min(b, sb) - max(a, sa)) / 1e9
                k += 1
        return {"device_ops": [[n, s] for n, s in ops.most_common(top)],
                "idle_gaps": [[n, s] for n, s in idle.most_common(top)]}
