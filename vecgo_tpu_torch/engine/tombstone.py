"""LSN-versioned tombstones per segment (reference: engine/tombstone.go:47
VersionedTombstones + pooled TombstoneFilter).

A delete of a row living in an immutable segment records (row, lsn). A snapshot
at LSN S sees the row deleted iff some tombstone lsn <= S. The device-facing
artifact is a dense bool mask per (segment, snapshot-lsn) — cheap to build
vectorized and cached per snapshot.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np

from vecgo_tpu_torch.storage import container


class SegmentTombstones:
    """Tombstones for one segment."""

    def __init__(self, n_rows: int, rows=None, lsns=None):
        self.n_rows = n_rows
        self.rows = np.asarray(rows if rows is not None else [], np.int64)
        self.lsns = np.asarray(lsns if lsns is not None else [], np.int64)

    def add(self, row: int, lsn: int) -> "SegmentTombstones":
        """Functional append (copy-on-write; snapshots hold old versions)."""
        return SegmentTombstones(
            self.n_rows,
            np.append(self.rows, row),
            np.append(self.lsns, lsn),
        )

    def deleted_mask(self, snapshot_lsn: Optional[int] = None) -> np.ndarray:
        """Dense bool [n_rows]: True = deleted at snapshot."""
        mask = np.zeros(self.n_rows, bool)
        if len(self.rows) == 0:
            return mask
        if snapshot_lsn is None:
            mask[self.rows] = True
        else:
            vis = self.lsns <= snapshot_lsn
            mask[self.rows[vis]] = True
        return mask

    def count(self, snapshot_lsn: Optional[int] = None) -> int:
        if snapshot_lsn is None:
            return int(len(np.unique(self.rows)))
        return int(len(np.unique(self.rows[self.lsns <= snapshot_lsn])))

    def to_bytes(self) -> bytes:
        return container.pack_container(
            {"kind": "tombstones", "n_rows": self.n_rows},
            {"rows": self.rows, "lsns": self.lsns},
        )

    @staticmethod
    def from_bytes(data: bytes) -> "SegmentTombstones":
        meta, secs = container.unpack_container(data)
        return SegmentTombstones(meta["n_rows"], secs["rows"], secs["lsns"])


class TombstoneSet:
    """Immutable-ish map seg_id -> SegmentTombstones, copy-on-write per delete.

    The engine publishes a new TombstoneSet pointer on each delete; snapshots
    capture the pointer (RCU discipline, reference snapshot.go).
    """

    def __init__(self, by_seg: Optional[Dict[int, SegmentTombstones]] = None):
        self.by_seg = dict(by_seg or {})

    def with_delete(self, seg_id: int, row: int, lsn: int, n_rows: int) -> "TombstoneSet":
        new = dict(self.by_seg)
        ts = new.get(seg_id) or SegmentTombstones(n_rows)
        new[seg_id] = ts.add(row, lsn)
        return TombstoneSet(new)

    def deleted_mask(self, seg_id: int, n_rows: int, snapshot_lsn=None) -> Optional[np.ndarray]:
        ts = self.by_seg.get(seg_id)
        if ts is None or len(ts.rows) == 0:
            return None
        return ts.deleted_mask(snapshot_lsn)

    def count(self, seg_id: int, snapshot_lsn=None) -> int:
        ts = self.by_seg.get(seg_id)
        return ts.count(snapshot_lsn) if ts else 0
