"""Refcounted MVCC snapshots (reference: engine/snapshot.go:13-165 — RCU via
atomic pointer, refcounted segments with on-close deletion).

Python translation of the discipline: the engine publishes an immutable
Snapshot; searches acquire() it (refcount++) and release() when done. Segment
handles track obsolescence (replaced by compaction) — their blobs are only
physically deleted by vacuum() once no retained manifest references them and
no live snapshot holds them.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple


class SegmentHandle:
    """A refcounted open segment (reference: RefCountedSegment)."""

    def __init__(self, segment, info, on_last_release: Optional[Callable] = None):
        self.segment = segment  # FlatSegment | VamanaSegment
        self.info = info  # manifest.SegmentInfo
        self._refs = 1  # engine's own reference
        self._obsolete = False
        self._on_last_release = on_last_release
        self._lock = threading.Lock()

    @property
    def seg_id(self) -> int:
        return self.segment.seg_id

    def inc_ref(self):
        with self._lock:
            self._refs += 1

    def dec_ref(self):
        fire = False
        with self._lock:
            self._refs -= 1
            if self._refs == 0 and self._obsolete and self._on_last_release:
                fire = True
        if fire:
            self._on_last_release(self)

    def mark_obsolete(self):
        fire = False
        with self._lock:
            self._obsolete = True
            if self._refs == 0 and self._on_last_release:
                fire = True
        if fire:
            self._on_last_release(self)


@dataclass
class Snapshot:
    """Immutable view: (lsn, memtable cut, segment set, tombstone version)."""

    lsn: int
    version: int
    memtable: object  # MemTable
    mem_rows: int
    segments: Tuple[SegmentHandle, ...]
    tombstones: object  # TombstoneSet

    def acquire(self):
        for h in self.segments:
            h.inc_ref()
        return self

    def release(self):
        for h in self.segments:
            h.dec_ref()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()


class SnapshotTracker:
    """Tracks live snapshot LSNs so PK chain compaction stays safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self._live: dict = {}

    def register(self, snap: Snapshot):
        with self._lock:
            self._live[id(snap)] = snap.lsn

    def unregister(self, snap: Snapshot):
        with self._lock:
            self._live.pop(id(snap), None)

    def min_live_lsn(self, default: int) -> int:
        with self._lock:
            return min(self._live.values(), default=default)
