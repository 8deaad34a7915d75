"""Versioned manifests + CURRENT pointer (reference: internal/manifest —
manifest.go:19-23 MANIFEST-%06d + CURRENT, Save:194, ListVersions:147).

Each commit writes an immutable MANIFEST-%06d.json and swings CURRENT via the
store's CAS where available — append-only history enables time travel
(engine.go:289-313) and multi-writer safety (S3-Express/DDB CAS analogue,
SURVEY.md §2.4).
"""

from __future__ import annotations

import json
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from vecgo_tpu_torch.blobstore import BlobStore
from vecgo_tpu_torch.errors import ErrConflict, ErrCorrupt, ErrNotFound

CURRENT = "CURRENT"
PREFIX = "MANIFEST-"


@dataclass
class SegmentInfo:
    """Reference: manifest.SegmentInfo (level/rowcount/path/stats)."""

    name: str  # blob name
    seg_id: int
    kind: str  # flat | vamana
    level: int
    row_count: int
    stats: Dict[str, Any] = field(default_factory=dict)
    tombstone_blob: Optional[str] = None

    def to_dict(self):
        return {
            "name": self.name,
            "seg_id": self.seg_id,
            "kind": self.kind,
            "level": self.level,
            "row_count": self.row_count,
            "stats": self.stats,
            "tombstone_blob": self.tombstone_blob,
        }

    @staticmethod
    def from_dict(d):
        return SegmentInfo(
            name=d["name"],
            seg_id=d["seg_id"],
            kind=d["kind"],
            level=d["level"],
            row_count=d["row_count"],
            stats=d.get("stats", {}),
            tombstone_blob=d.get("tombstone_blob"),
        )


@dataclass
class Manifest:
    version: int
    lsn: int
    next_id: int
    next_seg_id: int
    segments: List[SegmentInfo] = field(default_factory=list)
    pk_checkpoint: Optional[str] = None
    config: Dict[str, Any] = field(default_factory=dict)
    created_at: float = 0.0

    def to_bytes(self) -> bytes:
        body = json.dumps(
            {
                "version": self.version,
                "lsn": self.lsn,
                "next_id": self.next_id,
                "next_seg_id": self.next_seg_id,
                "segments": [s.to_dict() for s in self.segments],
                "pk_checkpoint": self.pk_checkpoint,
                "config": self.config,
                "created_at": self.created_at,
            },
            separators=(",", ":"),
        ).encode()
        crc = zlib.crc32(body) & 0xFFFFFFFF
        return json.dumps({"crc32": crc}).encode() + b"\n" + body

    @staticmethod
    def from_bytes(data: bytes) -> "Manifest":
        try:
            head, body = data.split(b"\n", 1)
            crc = json.loads(head)["crc32"]
            if (zlib.crc32(body) & 0xFFFFFFFF) != crc:
                raise ErrCorrupt("manifest checksum mismatch")
            d = json.loads(body)
            return Manifest(
                version=d["version"],
                lsn=d["lsn"],
                next_id=d["next_id"],
                next_seg_id=d["next_seg_id"],
                segments=[SegmentInfo.from_dict(s) for s in d["segments"]],
                pk_checkpoint=d.get("pk_checkpoint"),
                config=d.get("config", {}),
                created_at=d.get("created_at", 0.0),
            )
        except ErrCorrupt:
            raise
        except Exception as e:
            raise ErrCorrupt(f"bad manifest: {e}")


def _name(version: int) -> str:
    return f"{PREFIX}{version:06d}.json"


class ManifestStore:
    """Load/save versioned manifests over a BlobStore.

    `commit_store` (optional) is a DDB-style conditional-write commit plane
    (blobstore.s3.DDBCommitStore): when set, it is the AUTHORITY for the
    CURRENT pointer — version swings go through its CAS, giving multi-writer
    safety even when the object store's put_if_not_exists is not atomic
    (reference: ddb_commit_store.go:105-172). The CURRENT blob is still
    written afterwards as a best-effort mirror for commit-store-less readers.
    """

    def __init__(self, store: BlobStore, commit_store=None):
        self.store = store
        self.commit_store = commit_store

    def exists(self) -> bool:
        if self.commit_store is not None:
            if self.commit_store.current_version() is not None:
                return True
        return self.store.exists(CURRENT)

    def current_version(self) -> int:
        if self.commit_store is not None:
            v = self.commit_store.current_version()
            if v is not None:
                return int(v)
            raise ErrNotFound(CURRENT)
        try:
            return int(self.store.get(CURRENT).decode().strip())
        except ErrNotFound:
            raise
        except Exception as e:
            raise ErrCorrupt(f"bad CURRENT: {e}")

    def load(self, version: Optional[int] = None, as_of: Optional[float] = None) -> Manifest:
        """Load latest / specific version / latest version at timestamp
        (time travel, reference engine.go:499-534)."""
        if version is None and as_of is not None:
            version = self._version_at(as_of)
        if version is None:
            version = self.current_version()
        return Manifest.from_bytes(self.store.get(_name(version)))

    def _version_at(self, ts: float) -> int:
        best = None
        for v in self.list_versions():
            m = self.load(v)
            if m.created_at <= ts and (best is None or v > best):
                best = v
        if best is None:
            raise ErrNotFound(f"no manifest at or before timestamp {ts}")
        return best

    def list_versions(self) -> List[int]:
        out = []
        for name in self.store.list(PREFIX):
            try:
                out.append(int(name[len(PREFIX) :].split(".")[0]))
            except ValueError:
                continue
        return sorted(out)

    def save(self, m: Manifest, expect_version: Optional[int] = None) -> None:
        """Write MANIFEST then swing CURRENT.

        The manifest blob itself is CAS'd (put_if_not_exists): two writers
        racing to the same version conflict at the blob, giving single-writer
        semantics (reference: ddb_commit_store.go conditional writes).
        """
        m.created_at = m.created_at or time.time()
        try:
            self.store.put_if_not_exists(_name(m.version), m.to_bytes())
        except ErrConflict:
            raise ErrConflict(
                f"manifest version {m.version} already committed by another writer"
            )
        if self.commit_store is not None:
            # Conditional pointer swing: expect the caller's view of the
            # previous version (or the plane's own read). A concurrent writer
            # that committed in between fails the condition -> ErrConflict,
            # and the freshly-written manifest blob becomes an orphan for GC.
            prev = expect_version
            if prev is None:
                prev = self.commit_store.current_version()
            self.commit_store.commit_version(m.version, expect_previous=prev)
        self.store.put(CURRENT, str(m.version).encode())

    def vacuum(self, keep_versions: int, keep_duration_s: float = 0.0):
        """Delete old manifests beyond the retention policy; returns the set of
        segment blob names still referenced by retained manifests
        (reference: engine.Vacuum:1979, RetentionPolicy)."""
        versions = self.list_versions()
        if not versions:
            return set(), []
        current = self.current_version()
        now = time.time()
        keep = set(v for v in versions[-max(keep_versions, 1) :])
        keep.add(current)
        if keep_duration_s > 0:
            for v in versions:
                m = self.load(v)
                if now - m.created_at <= keep_duration_s:
                    keep.add(v)
        referenced = set()
        deleted = []
        for v in versions:
            if v in keep:
                m = self.load(v)
                for s in m.segments:
                    referenced.add(s.name)
                    if s.tombstone_blob:
                        referenced.add(s.tombstone_blob)
                if m.pk_checkpoint:
                    referenced.add(m.pk_checkpoint)
            else:
                self.store.delete(_name(v))
                deleted.append(v)
        return referenced, deleted
