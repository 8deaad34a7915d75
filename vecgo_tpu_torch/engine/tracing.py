"""Spans and counters of the search path.

A query batch gets a trace context (`Batch`, with an id from a process-wide
counter) when the planner takes it; every span and counter of that batch
carries the id, from its plan to `_finish`. Spans nest per thread, so each
record names its parent span.

Where they go:

- `recording()` installs a bounded in-memory `Recorder` for the process and
  returns it; operators and tests read the spans and counters from it.
- While `torch.profiler` records (or `emit_nvtx` is on), each span also opens
  `record_function("vecgo.<name>")`, so the spans sit in the profiler's
  trace beside the kernels they launch, on the trace's own clock.
- A batch searched with `with_stats` keeps its own span times and counters
  for its `QueryStats`, with no recorder installed.

Otherwise tracing is off: `span()` checks the recorder, the profiler's flag
and the batch, and returns a shared no-op context. A counter whose value
costs work is given as a callable, which `count` calls only where the value
goes. Off, the search path enters no `record_function`, records no CUDA
event, makes no extra pass over its arrays and no sync.

Device milliseconds (`device_timer`) come from a pair of timing events
around work enqueued on the current stream. They are read by `read_device`
once the batch's own completion event is done, never by a sync of their own.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import namedtuple
from contextlib import contextmanager

import torch
import torch.autograd.profiler as _profiler

__all__ = [
    "Batch", "CountRecord", "Recorder", "SpanRecord", "count", "device_timer", "read_device",
    "recording", "span",
]

SpanRecord = namedtuple("SpanRecord", "name batch parent t0_ns t1_ns")  # perf_counter_ns
CountRecord = namedtuple("CountRecord", "name batch n")

DEFAULT_LIMIT = 1_000_000  # records a Recorder keeps

_recorder = None  # the installed Recorder, or None
_local = threading.local()  # .stack: names of the thread's open spans
_ids = itertools.count(1)


class Recorder:
    """Spans and counters in arrival order, from every thread, at most
    `DEFAULT_LIMIT` of them; what arrives past the bound is counted in
    `dropped`."""

    def __init__(self):
        self.limit = DEFAULT_LIMIT
        self.records: list = []
        self.dropped = 0
        self._lock = threading.Lock()

    def add(self, rec) -> None:
        with self._lock:
            if len(self.records) < self.limit:
                self.records.append(rec)
            else:
                self.dropped += 1

    def spans(self, name=None) -> list:
        return [r for r in self.records
                if isinstance(r, SpanRecord) and (name is None or r.name == name)]

    def counts(self, name=None) -> list:
        return [r for r in self.records
                if isinstance(r, CountRecord) and (name is None or r.name == name)]


class Batch:
    """One query batch's trace context: its id and, where the batch asked for
    stats, its spans' host ns by name (`spans`), its counters summed by name
    (`counts`), the start of its first span and the end of its last.
    `events` holds the device timers not yet read."""

    __slots__ = ("id", "spans", "counts", "t0_ns", "t1_ns", "events")

    def __init__(self, with_stats: bool = False):
        self.id = next(_ids)
        self.spans = {} if with_stats else None
        self.counts = {} if with_stats else None
        self.t0_ns = self.t1_ns = None
        self.events: list = []


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class _Span:
    __slots__ = ("name", "batch", "parent", "t0", "rf")

    def __init__(self, name: str, batch):
        self.name, self.batch = name, batch

    def __enter__(self):
        st = _stack()
        self.parent = st[-1] if st else None
        st.append(self.name)
        self.rf = None
        if _profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function("vecgo." + self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _stack().pop()
        b, bid = self.batch, None
        if b is not None:
            bid = b.id
            if b.spans is not None:
                b.spans[self.name] = b.spans.get(self.name, 0) + t1 - self.t0
                b.t0_ns = self.t0 if b.t0_ns is None else min(b.t0_ns, self.t0)
                b.t1_ns = t1
        rec = _recorder
        if rec is not None:
            rec.add(SpanRecord(self.name, bid, self.parent, self.t0, t1))
        return False


def span(name: str, batch: Batch = None):
    """A context manager timing `name` for `batch`; a shared no-op while
    tracing is off."""
    if (_recorder is None and not _profiler._is_profiler_enabled
            and (batch is None or batch.spans is None)):
        return _OFF
    return _Span(name, batch)


def _counting(batch: Batch = None) -> bool:
    """Whether a counter of `batch` goes anywhere (a recorder, or the batch's
    own stats)."""
    return _recorder is not None or (batch is not None and batch.counts is not None)


def count(name: str, n, batch: Batch = None) -> None:
    """Record counter `name` = `n` for `batch`; nothing while it goes
    nowhere. `n` may be a callable, called only where the value goes."""
    if not _counting(batch):
        return
    if callable(n):
        n = n()
    if batch is not None and batch.counts is not None:
        batch.counts[name] = batch.counts.get(name, 0) + n
    rec = _recorder
    if rec is not None:
        rec.add(CountRecord(name, None if batch is None else batch.id, n))


class _DeviceTimer:
    __slots__ = ("name", "batch", "stream", "e0")

    def __init__(self, name: str, batch: Batch, device):
        self.name, self.batch = name, batch
        self.stream = torch.cuda.current_stream(device)

    def __enter__(self):
        self.e0 = torch.cuda.Event(enable_timing=True)
        self.e0.record(self.stream)
        return self

    def __exit__(self, *exc):
        e1 = torch.cuda.Event(enable_timing=True)
        e1.record(self.stream)
        self.batch.events.append((self.name, self.e0, e1))
        return False


def device_timer(name: str, batch: Batch, device):
    """A context manager timing the device work enqueued inside on the
    current CUDA stream, as counter `name` in ms once `read_device` runs; a
    shared no-op off the card or while no counter goes anywhere."""
    if batch is None or device.type != "cuda" or not _counting(batch):
        return _OFF
    return _DeviceTimer(name, batch, device)


def read_device(batch: Batch) -> None:
    """Count the batch's device timers. Call only after an event recorded
    behind them has completed."""
    if batch is None:
        return
    for name, e0, e1 in batch.events:
        count(name, e0.elapsed_time(e1), batch)
    batch.events.clear()


@contextmanager
def recording():
    """Install a `Recorder` for the process while inside; yields it."""
    global _recorder
    prev = _recorder
    rec = _recorder = Recorder()
    try:
        yield rec
    finally:
        _recorder = prev
