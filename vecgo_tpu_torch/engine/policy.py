"""Compaction policies (reference: engine/policy.go — size-tiered default with
threshold 4, BoundedSizeTieredPolicy:57, LeveledCompactionPolicy:123;
tombstone-driven rewrite from compaction.go).

A policy sees (seg_id, level, live_rows, total_rows) tuples and returns the
seg_ids to merge, or None.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, NamedTuple, Optional


class SegmentView(NamedTuple):
    seg_id: int
    level: int
    rows: int
    live_rows: int


class CompactionPolicy:
    def pick(self, segments: List[SegmentView]) -> Optional[List[int]]:
        raise NotImplementedError


@dataclass
class SizeTieredPolicy(CompactionPolicy):
    """Merge >= threshold segments of similar (log4) size; rewrite any segment
    whose live fraction fell below `min_live_fraction`."""

    threshold: int = 4
    min_live_fraction: float = 0.7

    def pick(self, segments):
        buckets = {}
        for s in segments:
            if s.rows and s.live_rows / s.rows < self.min_live_fraction:
                return [s.seg_id]
            b = int(math.log(max(s.live_rows, 1), 4))
            buckets.setdefault(b, []).append(s.seg_id)
        for ids in buckets.values():
            if len(ids) >= self.threshold:
                return ids
        return None


@dataclass
class BoundedSizeTieredPolicy(CompactionPolicy):
    """Size-tiered with a cap on rows merged at once (bounds merge cost;
    reference: policy.go:57)."""

    threshold: int = 4
    max_merge_rows: int = 2_000_000
    min_live_fraction: float = 0.7

    def pick(self, segments):
        base = SizeTieredPolicy(self.threshold, self.min_live_fraction).pick(segments)
        if not base:
            return None
        by_id = {s.seg_id: s for s in segments}
        picked, total = [], 0
        for sid in sorted(base, key=lambda i: by_id[i].live_rows):
            r = by_id[sid].live_rows
            if picked and total + r > self.max_merge_rows:
                break
            picked.append(sid)
            total += r
        return picked if len(picked) >= 2 or len(base) == 1 else None


@dataclass
class LeveledPolicy(CompactionPolicy):
    """Leveled: level L holds up to fanout^L * base_rows; overflowing levels
    merge into L+1 (reference: policy.go:123)."""

    base_rows: int = 100_000
    fanout: int = 10
    max_level_segments: int = 4

    def pick(self, segments):
        by_level = {}
        for s in segments:
            by_level.setdefault(s.level, []).append(s)
        for level in sorted(by_level):
            segs = by_level[level]
            cap = self.base_rows * (self.fanout**level)
            too_many = len(segs) > self.max_level_segments
            too_big = sum(s.live_rows for s in segs) > cap * self.max_level_segments
            if too_many or too_big:
                ids = [s.seg_id for s in segs]
                # Pull in next level for a true leveled merge.
                ids += [s.seg_id for s in by_level.get(level + 1, [])]
                return ids
        return None
