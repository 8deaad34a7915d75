"""Metrics / observability hooks (reference: engine/metrics.go:6-40 —
MetricsObserver with OnInsert/OnDelete/OnSearch/OnFlush/OnCompaction/
OnMemTableStatus/OnBackpressure/OnQueueDepth/OnThroughput, Noop default,
Prometheus adapter in examples/observability).
"""

from __future__ import annotations

import threading
import time
from typing import Dict


class MetricsObserver:
    """Override any subset; default everything is a no-op (reference: Noop)."""

    def on_insert(self, n: int) -> None: ...

    def on_delete(self, n: int) -> None: ...

    def on_search(self, n_queries: int, duration_s: float = 0.0) -> None: ...

    def on_get(self, n: int = 1) -> None: ...

    def on_flush(self, rows: int, duration_s: float) -> None: ...

    def on_compaction(self, n_inputs: int, rows_out: int, duration_s: float) -> None: ...

    def on_build(self, rows: int, duration_s: float) -> None: ...

    def on_memtable_status(self, rows: int, bytes: int) -> None: ...

    def on_backpressure(self) -> None: ...

    def on_queue_depth(self, depth: int) -> None: ...


NoopObserver = MetricsObserver


class CountingObserver(MetricsObserver):
    """Thread-safe counter observer (handy default; the analogue of the
    Prometheus example adapter — export `.counters` to any metrics system)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counters: Dict[str, float] = {}
        self.timings: Dict[str, float] = {}

    def _inc(self, key: str, n: float = 1.0):
        with self._lock:
            self.counters[key] = self.counters.get(key, 0.0) + n

    def _time(self, key: str, s: float):
        with self._lock:
            self.timings[key] = self.timings.get(key, 0.0) + s

    def on_insert(self, n):
        self._inc("inserts", n)

    def on_delete(self, n):
        self._inc("deletes", n)

    def on_search(self, n_queries, duration_s=0.0):
        self._inc("searches", n_queries)
        self._time("search_s", duration_s)

    def on_get(self, n=1):
        self._inc("gets", n)

    def on_flush(self, rows, duration_s):
        self._inc("flushes")
        self._inc("flushed_rows", rows)
        self._time("flush_s", duration_s)

    def on_compaction(self, n_inputs, rows_out, duration_s):
        self._inc("compactions")
        self._inc("compacted_rows", rows_out)
        self._time("compaction_s", duration_s)

    def on_build(self, rows, duration_s):
        self._inc("builds")
        self._time("build_s", duration_s)

    def on_memtable_status(self, rows, bytes):
        with self._lock:
            self.counters["memtable_rows"] = rows
            self.counters["memtable_bytes"] = bytes

    def on_backpressure(self):
        self._inc("backpressure")

    def on_queue_depth(self, depth):
        with self._lock:
            self.counters["queue_depth"] = depth
