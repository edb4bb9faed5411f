"""The traced window: a ``torch.profiler`` trace of the card alone (CUPTI),
read from its raw device events (the profiler's event tree is never
built), and the benchmark's own host spans around the program's calls, on
the same clock (both are nanoseconds since the epoch)."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class Spans:
    """Host spans: (name, start ns, end ns), kept in memory."""

    def __init__(self):
        self.items: list[tuple[str, int, int]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.items.append((name, t0, time.time_ns()))

    def total_s(self, name: str) -> float:
        return sum(e - s for n, s, e in self.items if n == name) / 1e9

    def count(self, name: str) -> int:
        return sum(1 for n, _, _ in self.items if n == name)


class NoSpans(Spans):
    """The untraced run: no clock reads."""

    @contextlib.contextmanager
    def span(self, name: str):
        yield


class DeviceTrace:
    """Device events (name, start ns, end ns) of a profiled window and the
    window's host bounds."""

    def __init__(self, events, t0: int, t1: int):
        self.events = sorted(events, key=lambda e: e[1])
        self.t0, self.t1 = t0, t1

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy_intervals(self) -> list[tuple[int, int]]:
        """The union of the device events, clipped to the window."""
        out: list[list[int]] = []
        for _, s, e in self.events:
            s, e = max(s, self.t0), min(e, self.t1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def kernel_s(self, *patterns: str) -> float:
        """Summed device seconds of the events whose name holds any pattern."""
        return sum(e - s for n, s, e in self.events if any(p in n for p in patterns)) / 1e9

    def top_ops(self, k: int = 10) -> list:
        by = defaultdict(int)
        for n, s, e in self.events:
            by[n[:160]] += e - s
        return [[n, ns / 1e9] for n, ns in sorted(by.items(), key=lambda x: -x[1])[:k]]

    def idle_gaps(self, spans: Spans, k: int = 10) -> list:
        """The k longest idle gaps on the device, each named by the host span
        open when it began."""
        busy = self.busy_intervals()
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:k]:
            open_spans = [n for n, a, b in spans.items if a <= s < b]
            out.append([f"host:{open_spans[-1] if open_spans else 'other'}", (e - s) / 1e9])
        return out


@contextlib.contextmanager
def device_trace(enabled: bool):
    """Yields a holder whose ``.trace`` is a DeviceTrace once the block ends
    (None when not enabled or on a machine without a card)."""
    import torch

    holder = type("Holder", (), {"trace": None})()
    if not enabled or not torch.cuda.is_available():
        yield holder
        return
    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.time_ns()
        yield holder
        torch.cuda.synchronize()
        t1 = time.time_ns()
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events() if e.device_type() == DeviceType.CUDA]
    holder.trace = DeviceTrace(events, t0, t1)
