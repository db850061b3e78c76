"""Spans and the device trace of a traced run.

The benchmark puts a ``record_function`` range (a span) around each call
into a layer of the program; ``spanned`` wraps a bound method so.  A
``Window`` runs ``torch.profiler`` over the traced work, from a
synchronised device to a synchronised device, and ``reduce`` turns its
events into what the metric readers read:

* ``busy_s``: the union of the intervals in which an operation ran on the
  device; ``window_s``: the window's length on the host clock;
* ``kernels``: device seconds and launches by kernel name;
* ``spans``: each span's device seconds (``Spans``) and calls;
* ``device_ops`` and ``idle_gaps`` for the breakdown: the kernels that took
  most time, and the longest idle gaps named by the span and the host
  operation that was running while the device waited.
"""

from __future__ import annotations

import bisect
import functools
import time
from collections import defaultdict
from typing import Dict, List

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

PREFIX = "wtv."


class Spans:
    """Spans around calls into the program's layers.  Each call is a
    ``record_function`` range (the profiler's host timeline) and, while
    ``timing``, a pair of CUDA events on the current stream: a span's device
    time is the time the stream took from the call's first work to its
    last.  Events, unlike the profiler's host ranges, see calls made on any
    thread, such as the serving worker's."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.timing = False
        self.events: Dict[str, list] = defaultdict(list)

    def wrap(self, name: str, fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with record_function(PREFIX + name):
                if not (self.timing and self.cuda):
                    return fn(*args, **kwargs)
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                try:
                    return fn(*args, **kwargs)
                finally:
                    end.record()
                    self.events[name].append((start, end))
        return call

    def reset(self) -> None:
        self.events.clear()

    def read(self) -> Dict[str, dict]:
        """{span: {"device_s", "calls"}} of the calls timed so far (after a
        synchronise)."""
        return {n: {"device_s": sum(s.elapsed_time(e) for s, e in ev) / 1e3, "calls": len(ev)}
                for n, ev in self.events.items()}


class Window:
    """The profiled window; on a CPU device (the tests) the host alone.
    ``spans`` time their calls while it is open."""

    def __init__(self, device: torch.device, spans: Spans):
        self.cuda = device.type == "cuda"
        self.spans = spans

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def __enter__(self):
        self._sync()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        self.prof = profile(activities=acts)
        self.spans.reset()
        self.spans.timing = True
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.window_s = time.perf_counter() - self.t0
        self.spans.timing = False
        self.prof.__exit__(*exc)
        return False


def _union(intervals: List[tuple]) -> List[tuple]:
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce(window: Window, top: int = 10) -> dict:
    events = window.prof.events()
    # the device side of a span (a user annotation) is no operation
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not e.name.startswith(PREFIX)]
    host = [e for e in events if e.device_type == DeviceType.CPU]
    kernels: Dict[str, list] = defaultdict(lambda: [0.0, 0])
    for e in device:
        k = kernels[e.name]
        k[0] += (e.time_range.end - e.time_range.start) / 1e6
        k[1] += 1
    merged = _union([(e.time_range.start, e.time_range.end) for e in device])
    busy_s = sum(e - s for s, e in merged) / 1e6

    span_ev = sorted((e for e in host if e.name.startswith(PREFIX)),
                     key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in span_ev]

    def span_at(t: float):
        # the spans do not nest: the one that opened last before t, if still open
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and span_ev[i].time_range.end >= t:
            return span_ev[i].name[len(PREFIX):]
        return None

    gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(merged, merged[1:])), reverse=True)
    idle = []
    plain = sorted((e for e in host if not e.name.startswith(PREFIX)),
                   key=lambda e: e.time_range.start)
    for length, s, e in gaps[:top]:
        mid = (s + e) / 2
        op = None
        for ev in plain:
            if ev.time_range.start > mid:
                break
            if ev.time_range.end >= mid:
                op = ev.name
        span = span_at(mid)
        idle.append([f"{span or 'no span'}: {op or 'no host op'}", length / 1e6])
    ops = sorted(([n, v[0]] for n, v in kernels.items()), key=lambda x: -x[1])[:top]
    return {"window_s": window.window_s, "busy_s": busy_s,
            "kernels": {n: {"s": v[0], "n": v[1]} for n, v in kernels.items()},
            "spans": window.spans.read(), "device_ops": ops, "idle_gaps": idle}
