"""MVCC primary-key index: bulk blocks + per-id LSN version chains.

Reference: internal/pk/mvcc.go:35-125 (per-entry version chains, Get(id, lsn),
Upsert, Delete, Scan) and persist.go (binary checkpoint).

TPU-first restructuring of the hot path: bulk ingestion (the reference's
deferred mode, doc.go:33-35, ~2M vec/s) registers one **block** — sorted id /
row / LSN numpy arrays for a whole batch — in O(1) instead of a dict insert
per row. Point lookups binary-search the blocks; ids that are later updated
or deleted get explicit version **chains** that shadow their block entry
(chain LSNs are always newer). Invariant: an id appears in at most one block.

Location convention: seg_id == MEMTABLE_SEG (-1) addresses the active
memtable; row is the row within the segment/memtable. seg_id == DELETED marks
a delete. row == -1 marks a stale version whose physical row was dropped by
compaction (never the visible latest).
"""

from __future__ import annotations

import threading
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from vecgo_tpu_torch.utils.hostmem import huge_arange

MEMTABLE_SEG = -1

# chain entry: (lsn, seg_id, row); deletes encoded as seg_id == DELETED
DELETED = -2


class _Block:
    """One bulk-ingested id range: ids sorted ascending, aligned rows/lsns."""

    __slots__ = ("ids", "rows", "lsns", "seg_id")

    def __init__(self, ids: np.ndarray, rows: np.ndarray, lsns: np.ndarray, seg_id: int):
        self.ids = ids
        self.rows = rows
        self.lsns = lsns
        self.seg_id = seg_id

    def find(self, id: int) -> int:
        """Index of id, or -1."""
        i = int(np.searchsorted(self.ids, id))
        if i < len(self.ids) and int(self.ids[i]) == id:
            return i
        return -1


class PKIndex:
    """id -> (bulk block entry) shadowed by an ascending-LSN chain."""

    def __init__(self):
        self._chains: Dict[int, List[Tuple[int, int, int]]] = {}
        self._blocks: List[_Block] = []
        self._lock = threading.Lock()
        # ids with >1 live version (updated/deleted/block+chain): only these
        # need a per-candidate visibility check at search time.
        self._dirty: set = set()
        self._dirty_version = 0
        self._dirty_cache = None  # (version, sorted int64 array)

    # ---------------- internals ----------------

    def _block_entry(self, id: int) -> Optional[Tuple[int, int, int]]:
        for b in reversed(self._blocks):
            i = b.find(id)
            if i >= 0:
                return (int(b.lsns[i]), b.seg_id, int(b.rows[i]))
        return None

    def __len__(self):
        n = sum(len(b.ids) for b in self._blocks)
        n += sum(1 for id in self._chains if self._block_entry(id) is None)
        return n

    def _mark_dirty(self, id: int):
        self._dirty.add(id)
        self._dirty_version += 1

    def dirty_sorted(self) -> "np.ndarray":
        """Sorted array of multi-version ids (cached) for vectorized isin."""
        with self._lock:
            cache = self._dirty_cache
            if cache is not None and cache[0] == self._dirty_version:
                return cache[1]
            arr = np.fromiter(self._dirty, np.int64, len(self._dirty))
            arr.sort()
            self._dirty_cache = (self._dirty_version, arr)
            return arr

    # ---------------- writes ----------------

    def upsert(self, id: int, seg_id: int, row: int, lsn: int) -> None:
        with self._lock:
            chain = self._chains.setdefault(id, [])
            chain.append((lsn, seg_id, row))
            if len(chain) > 1 or self._block_entry(id) is not None:
                self._mark_dirty(id)

    def upsert_block(
        self, ids: np.ndarray, seg_id: int, rows: np.ndarray, lsn0: int
    ) -> None:
        """Register a bulk batch: ids sorted ascending and FRESH (never seen
        by this index); rows aligned; entry i has LSN lsn0 + i."""
        with self._lock:
            self._blocks.append(
                _Block(
                    np.asarray(ids, np.int64),
                    np.asarray(rows, np.int64),
                    huge_arange(lsn0, len(ids)),
                    seg_id,
                )
            )

    def contains_any_sorted(self, ids: np.ndarray) -> bool:
        """True if ANY of the (sorted ascending) ids is already known —
        the freshness gate for the explicit-id bulk ingest path."""
        with self._lock:
            for blk in self._blocks:
                pos = np.searchsorted(blk.ids, ids)
                pos = np.minimum(pos, len(blk.ids) - 1)
                if len(blk.ids) and (blk.ids[pos] == ids).any():
                    return True
            if self._chains:
                keys = np.fromiter(
                    self._chains.keys(), np.int64, len(self._chains)
                )
                lo = np.searchsorted(ids, keys)
                lo = np.minimum(lo, len(ids) - 1)
                if len(ids) and (ids[lo] == keys).any():
                    return True
        return False

    def delete(self, id: int, lsn: int) -> bool:
        """Record a delete; returns False if id has never existed."""
        with self._lock:
            chain = self._chains.get(id)
            if chain:
                chain.append((lsn, DELETED, 0))
                self._mark_dirty(id)
                return True
            if self._block_entry(id) is not None:
                self._chains[id] = [(lsn, DELETED, 0)]
                self._mark_dirty(id)
                return True
            return False

    # ---------------- reads ----------------

    def get(self, id: int, snapshot_lsn: Optional[int] = None) -> Optional[Tuple[int, int]]:
        """Visible (seg_id, row) at snapshot_lsn (None = latest)."""
        ent = self.get_entry(id, snapshot_lsn)
        if ent is None or ent[1] == DELETED:
            return None
        return (ent[1], ent[2])

    def get_entry(self, id: int, snapshot_lsn: Optional[int] = None):
        """Visible entry (lsn, seg_id, row) at snapshot (seg_id may be
        DELETED); None if nothing is visible."""
        chain = self._chains.get(id)
        if chain:
            for entry in reversed(chain):
                if snapshot_lsn is None or entry[0] <= snapshot_lsn:
                    return entry
        ent = self._block_entry(id)
        if ent is not None and (snapshot_lsn is None or ent[0] <= snapshot_lsn):
            return ent
        return None

    def latest_entry(self, id: int):
        chain = self._chains.get(id)
        if chain:
            return chain[-1]
        return self._block_entry(id)

    # ---------------- remapping (flush/compaction) ----------------

    def remap_bulk(self, old_seg: int, new_seg: int, row_map: np.ndarray) -> None:
        """Rewrite locations after flush/compaction, vectorized: every entry at
        (old_seg, row) moves to (new_seg, row_map[row]); row_map[row] == -1
        marks rows physically dropped (stale versions only)."""
        with self._lock:
            for b in self._blocks:
                if b.seg_id == old_seg:
                    b.rows = np.where(
                        b.rows >= 0, row_map[np.maximum(b.rows, 0)], -1
                    )
                    b.seg_id = new_seg
            for chain in self._chains.values():
                for i, (lsn, seg, row) in enumerate(chain):
                    if seg == old_seg:
                        nr = int(row_map[row]) if 0 <= row < len(row_map) else -1
                        chain[i] = (lsn, new_seg, nr)

    def remap(self, mapping: Dict[Tuple[int, int], Tuple[int, int]]) -> None:
        """Dict-based remap (legacy; chains + blocks). Entries absent from the
        mapping keep their location in chains; block entries of a remapped
        segment that are absent were dropped rows (-1)."""
        with self._lock:
            segs: Dict[int, Dict[int, Tuple[int, int]]] = {}
            for (os_, or_), new in mapping.items():
                segs.setdefault(os_, {})[or_] = new
            for b in self._blocks:
                rows_for_seg = segs.get(b.seg_id)
                if not rows_for_seg:
                    continue
                new_rows = np.full(len(b.rows), -1, np.int64)
                new_seg = None
                for i, row in enumerate(b.rows):
                    new = rows_for_seg.get(int(row))
                    if new is not None:
                        new_seg, new_rows[i] = new[0], new[1]
                if new_seg is not None:
                    b.rows = new_rows
                    b.seg_id = new_seg
            for chain in self._chains.values():
                for i, (lsn, seg, row) in enumerate(chain):
                    new = mapping.get((seg, row))
                    if new is not None:
                        chain[i] = (lsn, new[0], new[1])

    def compact_chains(self, min_lsn: int) -> None:
        """Drop chain entries superseded before min_lsn (no live snapshot older)."""
        with self._lock:
            dead = []
            for id, chain in self._chains.items():
                keep_from = 0
                for i, (lsn, _, _) in enumerate(chain):
                    if lsn <= min_lsn:
                        keep_from = i
                if keep_from:
                    del chain[:keep_from]
                if len(chain) == 1 and self._block_entry(id) is None:
                    if chain[0][1] == DELETED:
                        dead.append(id)
                    elif id in self._dirty:
                        self._dirty.discard(id)
                        self._dirty_version += 1
            for id in dead:
                del self._chains[id]
                self._dirty.discard(id)
            if dead:
                self._dirty_version += 1

    def scan(self, snapshot_lsn: Optional[int] = None) -> Iterator[Tuple[int, int, int]]:
        """Yield (id, seg_id, row) visible at snapshot."""
        chains = self._chains
        for b in self._blocks:
            vis = (
                np.ones(len(b.ids), bool)
                if snapshot_lsn is None
                else b.lsns <= snapshot_lsn
            )
            vis &= b.rows >= 0
            for i in np.flatnonzero(vis):
                id = int(b.ids[i])
                if id in chains:
                    continue  # resolved below
                yield id, b.seg_id, int(b.rows[i])
        for id in list(chains.keys()):
            loc = self.get(id, snapshot_lsn)
            if loc is not None and loc[1] >= 0:
                yield id, loc[0], loc[1]

    # ---------------- checkpoint ----------------

    def checkpoint_bytes(self, max_lsn: Optional[int] = None) -> bytes:
        """Serialize blocks + chains (reference: pk/persist.go:20-97).

        max_lsn bounds the checkpoint to DURABLE state: entries newer than the
        last committed manifest LSN — uncommitted upserts/deletes and anything
        addressing the volatile memtable — are stripped, matching the crash
        model (lose everything since last Commit). Without the strip, a
        checkpoint taken at Close would resurrect memtable locations that no
        longer exist on reopen."""
        from vecgo_tpu_torch.storage import container

        ids, lsns, segs, rows = [], [], [], []
        with self._lock:
            for id, chain in self._chains.items():
                for lsn, seg, row in chain:
                    if max_lsn is not None and (
                        lsn > max_lsn or seg == MEMTABLE_SEG
                    ):
                        continue
                    ids.append(id)
                    lsns.append(lsn)
                    segs.append(seg)
                    rows.append(row)
            sections = {
                "ids": np.asarray(ids, np.int64),
                "lsns": np.asarray(lsns, np.int64),
                "segs": np.asarray(segs, np.int64),
                "rows": np.asarray(rows, np.int64),
            }
            blk_meta = []
            bi = 0
            for b in self._blocks:
                if max_lsn is not None and (
                    b.seg_id == MEMTABLE_SEG
                    or (len(b.lsns) and int(b.lsns[0]) > max_lsn)
                ):
                    continue  # uncommitted bulk batch — volatile by design
                sections[f"blk{bi}.ids"] = b.ids
                sections[f"blk{bi}.rows"] = b.rows
                sections[f"blk{bi}.lsns"] = b.lsns
                blk_meta.append(b.seg_id)
                bi += 1
        return container.pack_container(
            {"kind": "pk_checkpoint", "entries": len(ids), "blocks": blk_meta},
            sections,
        )

    @staticmethod
    def from_checkpoint(data: bytes) -> "PKIndex":
        from vecgo_tpu_torch.storage import container

        meta, secs = container.unpack_container(data)
        pk = PKIndex()
        ids = secs["ids"]
        lsns = secs["lsns"]
        segs = secs["segs"]
        rows = secs["rows"]
        order = np.argsort(lsns, kind="stable")
        for i in order:
            pk._chains.setdefault(int(ids[i]), []).append(
                (int(lsns[i]), int(segs[i]), int(rows[i]))
            )
        for bi, seg_id in enumerate(meta.get("blocks", [])):
            pk._blocks.append(
                _Block(
                    np.asarray(secs[f"blk{bi}.ids"], np.int64),
                    np.asarray(secs[f"blk{bi}.rows"], np.int64),
                    np.asarray(secs[f"blk{bi}.lsns"], np.int64),
                    int(seg_id),
                )
            )
        pk._dirty = {
            id
            for id, c in pk._chains.items()
            if len(c) > 1 or pk._block_entry(id) is not None
        }
        pk._dirty_version += 1
        return pk

    @staticmethod
    def rebuild_from_segments(segments, tombstones) -> "PKIndex":
        """Vectorized rebuild after recovery without a checkpoint (reference:
        engine.go:620-712 batch scans). Ids unique across all segments become
        per-segment blocks; duplicated/tombstoned ids become chains (with
        per-row delete LSNs from the persisted tombstones)."""
        pk = PKIndex()
        if not segments:
            return pk
        all_ids = np.concatenate([np.asarray(s.ids, np.int64) for s in segments])
        uniq, counts = np.unique(all_ids, return_counts=True)
        dup_ids = uniq[counts > 1]
        for seg in segments:
            ids = np.asarray(seg.ids, np.int64)
            lsns = np.asarray(seg.lsns, np.int64)
            ts = tombstones.by_seg.get(seg.seg_id)
            tomb_rows = (
                np.asarray(ts.rows, np.int64) if ts is not None else np.zeros(0, np.int64)
            )
            chainy = np.isin(ids, dup_ids)
            if len(tomb_rows):
                tm = np.zeros(len(ids), bool)
                tm[tomb_rows[tomb_rows < len(ids)]] = True
                chainy |= tm
            keep = ~chainy
            order = np.argsort(ids[keep], kind="stable")
            rows_kept = np.flatnonzero(keep)[order]
            pk._blocks.append(
                _Block(ids[keep][order], rows_kept, lsns[keep][order], seg.seg_id)
            )
            for row in np.flatnonzero(chainy):
                pk._chains.setdefault(int(ids[row]), []).append(
                    (int(lsns[row]), seg.seg_id, int(row))
                )
            # Replay persisted tombstones at their real per-row delete LSNs.
            if ts is not None:
                for row, lsn in zip(ts.rows, ts.lsns):
                    pk._chains.setdefault(int(ids[int(row)]), []).append(
                        (int(lsn), DELETED, 0)
                    )
        # Order chains by LSN; at equal LSN (upsert tombstones the old row with
        # the new version's LSN) the DELETED entry sorts first so the live
        # version wins.
        for chain in pk._chains.values():
            chain.sort(key=lambda e: (e[0], e[1] != DELETED))
        pk._dirty = set(pk._chains.keys())
        pk._dirty_version += 1
        return pk

    @staticmethod
    def rebuild(segments) -> "PKIndex":
        """Legacy helper (tests): rebuild with later-segment-wins at LSN 0."""
        pk = PKIndex()
        for seg in segments:
            for row in range(seg.n):
                pk._chains.setdefault(int(seg.ids[row]), []).append(
                    (0, seg.seg_id, row)
                )
        pk._dirty = {id for id, c in pk._chains.items() if len(c) > 1}
        pk._dirty_version += 1
        return pk
