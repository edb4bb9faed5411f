"""Spans and counters at the boundaries of the port's layers.

A span is a named stretch of host time: the train step and its stages, the
batch feed, a render chunk, the extraction's stages, and every wait of the
host on the card (``wait.*``). Each is recorded on the clock of the device
trace, ``time.time_ns()`` (ns since the epoch, the clock of the CUPTI events
in a ``torch.profiler`` trace), so a span lies directly over the card's
timeline.

Recording is on only while a ``torch.profiler`` session records in the
process (``torch.autograd.profiler._is_profiler_enabled``). Off, opening and
closing a span is one flag read: ``span`` returns one shared no-op object,
reads no clock and allocates nothing.

A record keeps its name, start and end, its parent (the index of the span
that was open on the same thread when it opened), the id of the unit it
belongs to (a step, a frame or a volume: the nearest enclosing ``unit``
span, whose ``id`` it takes), its own ``id`` and its counts. Records are
kept in the order they opened, up to ``CAP``; spans past the cap are counted
in ``RECORDER.dropped`` and not kept. A unit opened with recording off
empties the buffer: the spans kept are those of the last session, until the
program works outside a session again (the benchmark's warm-up before its
traced window, the next run's set-up).

    with tracing.unit("train.step", state.step) as sp:
        sp.count("rays", B)
        with tracing.span("train.forward"):
            ...

``backward_span`` records a span around one autograd node's backward (on the
thread autograd runs it on). ``RECORDER.items`` gives the closed spans as
``(name, start_ns, end_ns)`` in the order they opened; ``summarize`` totals
them by name over a window.
``register_counters`` adds a dict of counts (a module's ``launch_counts``)
to ``counters()``'s snapshot.
"""

from __future__ import annotations

import json
import threading
import time
from pathlib import Path

import torch.autograd.profiler as _profiler

CAP = 1 << 20  # records kept a session


class _NoSpan:
    """The span of a process that is not recording."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None

    def count(self, key: str, value) -> None:
        return None


NO_SPAN = _NoSpan()


class Record:
    """One span: opened by ``with``, appended to the recorder at its start."""

    __slots__ = ("name", "id", "is_unit", "start_ns", "end_ns", "parent", "unit", "counts", "index", "_recorder")

    def __init__(self, recorder: "Recorder", name: str, id, is_unit: bool):
        self.name, self.id, self.is_unit, self._recorder = name, id, is_unit, recorder
        self.start_ns = self.end_ns = self.parent = self.unit = self.index = None
        self.counts: dict = {}

    def __enter__(self) -> "Record":
        self._recorder._open(self)
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.time_ns()
        self._recorder._close(self)

    def count(self, key: str, value) -> None:
        """Add ``value`` to the span's count ``key``."""
        self.counts[key] = self.counts.get(key, 0) + value

    def as_dict(self) -> dict:
        return {"name": self.name, "id": self.id, "start_ns": self.start_ns, "end_ns": self.end_ns,
                "parent": self.parent, "unit": self.unit, "counts": self.counts}


class Recorder:
    """The records of one session and each thread's stack of open spans."""

    def __init__(self):
        self.cap = CAP
        self.records: list[Record] = []
        self.dropped = 0
        self._local = threading.local()
        self._lock = threading.Lock()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _open(self, rec: Record) -> None:
        stack = self._stack()
        top = stack[-1] if stack else None
        rec.parent = None if top is None else top.index
        rec.unit = rec.id if rec.is_unit else (None if top is None else top.unit)
        with self._lock:
            if len(self.records) < self.cap:
                rec.index = len(self.records)
                self.records.append(rec)
            else:
                self.dropped += 1
        stack.append(rec)
        rec.start_ns = time.time_ns()

    def _close(self, rec: Record) -> None:
        self._stack().remove(rec)

    def clear(self) -> None:
        with self._lock:
            self.records.clear()
            self.dropped = 0

    @property
    def items(self) -> list[tuple[str, int, int]]:
        """The closed spans as (name, start_ns, end_ns), in the order they
        opened (what ``portbench.trace.DeviceTrace.idle_gaps`` reads)."""
        return [(r.name, r.start_ns, r.end_ns) for r in self.records if r.end_ns is not None]


RECORDER = Recorder()
_COUNTERS: dict[str, dict] = {}


def span(name: str, id=None):
    """A span named ``name`` (``id``: the chunk start, "coarse"/"fine", ...),
    to be opened with ``with``; the no-op span when nothing records."""
    if not _profiler._is_profiler_enabled:
        return NO_SPAN
    return Record(RECORDER, name, id, False)


def unit(name: str, id):
    """The span of one unit of work (a step, a frame, a volume) with its id;
    the spans opened inside it carry that id."""
    if not _profiler._is_profiler_enabled:
        if RECORDER.records:  # the program works outside a session: the last one's spans go
            RECORDER.clear()
        return NO_SPAN
    return Record(RECORDER, name, id, True)


def backward_span(t, name: str) -> None:
    """Record a span ``name`` around the backward of the op that made ``t``
    (on the thread autograd runs it on), when recording and ``t`` has one."""
    if not _profiler._is_profiler_enabled or t.grad_fn is None:
        return
    node = t.grad_fn
    rec = Record(RECORDER, name, None, False)

    def opened(grad_outputs):
        rec.__enter__()

    def closed(grad_inputs, grad_outputs):
        rec.__exit__(None, None, None)

    node.register_prehook(opened)
    node.register_hook(closed)


def clear() -> None:
    """Empty the buffer (a new session)."""
    RECORDER.clear()


def register_counters(group: str, counts: dict) -> None:
    """Add ``counts`` (a live dict of numbers) to the snapshot as ``group.key``."""
    _COUNTERS[group] = counts


def counters() -> dict:
    """A snapshot of every registered count, and the spans dropped past the cap."""
    out = {f"{group}.{k}": v for group, counts in _COUNTERS.items() for k, v in counts.items()}
    out["tracing.dropped"] = RECORDER.dropped
    return out


def summarize(t0: int | None = None, t1: int | None = None) -> dict:
    """Per span name over the closed spans clipped to [t0, t1] (ns; None:
    unbounded): {"n": spans that started in the window, "ns": their clipped
    time summed, "counts": the counts of those that started in it summed}."""
    lo = -1 if t0 is None else t0
    hi = float("inf") if t1 is None else t1
    out: dict = {}
    for r in RECORDER.records:
        if r.end_ns is None:
            continue
        s, e = max(r.start_ns, lo), min(r.end_ns, hi)
        if e < s:
            continue
        agg = out.setdefault(r.name, {"n": 0, "ns": 0, "counts": {}})
        agg["ns"] += e - s
        if lo <= r.start_ns < hi:
            agg["n"] += 1
            for k, v in r.counts.items():
                agg["counts"][k] = agg["counts"].get(k, 0) + v
    return out


def write_json(path) -> None:
    """The session's spans, the dropped count and the counters as JSON."""
    spans = [r.as_dict() for r in RECORDER.records if r.end_ns is not None]
    Path(path).write_text(json.dumps({"clock": "time.time_ns", "spans": spans, "dropped": RECORDER.dropped,
                                      "counters": counters()}))
