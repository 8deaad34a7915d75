"""The port's Engine (vecgo_tpu/engine/engine.py on PyTorch).

Open/recovery, CRUD, the PK index, manifests, tombstones, commit,
compaction, vacuum, close and the lexical hooks (BM25 indexing, RRF
hybrid search and its batched fusion) are the JAX engine's host code,
copied. What differs is what creates or searches device state: segments
and the memtable are the port's classes, compaction builds graphs on the
options' device, the search entry points run the device planner in
`vecgo_tpu_torch.engine.search`, the device BM25 snapshot sweeps its table
with `scan_topk`, and `sharded_searcher` serves the committed snapshot
from a grid of devices (`vecgo_tpu_torch.parallel`).

Threading model (as in the JAX engine): one writer lock guards mutations;
searches are lock-free against published immutable snapshots. File
deletion happens only in vacuum(), so time travel keeps working.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from dataclasses import dataclass, field as dc_field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from vecgo_tpu_torch.blobstore import BlobStore, LocalStore
from vecgo_tpu_torch.engine import search as search_mod
from vecgo_tpu_torch.engine.manifest import Manifest, ManifestStore, SegmentInfo
from vecgo_tpu_torch.engine.memtable import MemTable, copy_validate
from vecgo_tpu_torch.engine.pk import DELETED, MEMTABLE_SEG, PKIndex
from vecgo_tpu_torch.engine.policy import SegmentView, SizeTieredPolicy
from vecgo_tpu_torch.engine.resource import Controller, DeviceBudget
from vecgo_tpu_torch.engine.snapshot import SegmentHandle, Snapshot, SnapshotTracker
from vecgo_tpu_torch.engine.tombstone import SegmentTombstones, TombstoneSet
from vecgo_tpu_torch.errors import (
    ErrClosed,
    ErrCorrupt,
    ErrDimensionMismatch,
    ErrInvalidVector,
    ErrNotFound,
    ErrReadOnly,
)
from vecgo_tpu_torch.index.common import csr_concat, csr_select
from vecgo_tpu_torch.index.flat import FlatSegment, FlatWriter
from vecgo_tpu_torch.index.vamana import VamanaSegment, VamanaWriter
from vecgo_tpu_torch.lexical.bm25 import BM25Index
from vecgo_tpu_torch.lexical.device_bm25 import DeviceBM25
from vecgo_tpu_torch.metadata import Schema
from vecgo_tpu_torch.metadata.columnar import ColumnarMeta
from vecgo_tpu_torch.model import Candidate, Metric, SearchOptions, SearchResult
from vecgo_tpu_torch.storage import container
from vecgo_tpu_torch.utils.hostmem import all_finite, huge_arange
from vecgo_tpu_torch.utils.tensors import checked_device


@dataclass
class EngineOptions:
    """The JAX engine's options (same fields and defaults) plus the device that holds segments,
    memtable chunks and the BM25 snapshot's table, runs every scan and builds
    graphs ("cuda" by default; "cpu" runs the kernels' plain PyTorch versions)."""

    dim: int = 0
    metric: Metric = Metric.L2
    quantizer: str = "none"  # quantizer for flushed/compacted segments
    qparams: Dict[str, Any] = dc_field(default_factory=dict)
    flush_threshold: int = 100_000  # memtable rows before auto-flush
    graph_threshold: int = 32_768  # compaction output >= this -> vamana graph
    graph_r: int = 32
    graph_l_build: int = 64
    graph_alpha: Optional[float] = None  # None = per-mode default (1.5 clustered / 1.2 beam)
    graph_build_mode: str = "clustered"  # "clustered" (fast) | "beam"
    graph_build_params: Dict[str, Any] = dc_field(default_factory=dict)  # build_fast knobs (cluster_size, overlap, ...)
    ivf_rows_per_partition: int = 8192  # flat IVF rule (reference: rows/8192)
    # Train flat-IVF partitions at FLUSH time. The reference's flat writer
    # k-means-partitions every flush (flat/writer.go:101-147) because its
    # CPU scan wins by skipping partitions; on TPU the exact MXU sweep beats
    # partitioned probing at segment scale (docs/PERF.md: the nprobes flat
    # profile measures SLOWER than exact — the probe mask adds VPU work
    # without skipping blocks), so the flush-time k-means was pure commit
    # latency: 154 s of a 180 s 1M commit (probe_flush_phases). Default off;
    # compaction still partitions its (long-lived) outputs.
    flush_ivf_partitions: bool = False
    compaction_threshold: int = 4  # size-tiered trigger (reference default 4)
    compaction_policy: Any = None  # engine.policy.CompactionPolicy; None = size-tiered
    auto_flush: bool = True
    auto_compact: bool = True
    background: bool = False  # run flush/compaction on background threads
    flush_interval_s: float = 5.0  # background loop cadence
    memory_limit_bytes: int = 0  # host memtable cap; ErrBackpressure over it (0 = unlimited)
    hbm_budget_bytes: int = 0  # device residency budget; over-budget segments stream (0 = unlimited)
    schema: Optional[Schema] = None
    read_only: bool = False
    verify_checksum: bool = True
    compress_segments: str = ""  # "" | "lz4" | "zstd" | "deflate" (reference: LZ4/ZSTD blocks, diskann/compression.go)
    retention_versions: int = 10
    retention_duration_s: float = 0.0
    orphan_gc_grace_s: float = 3600.0  # min age before open-time orphan GC deletes
    ef_search: int = 64
    # Filtered graph search widens ef by 1/selectivity (the reference's
    # dynamic EF expansion, hnsw.go:1858-1895, capped 20,000) so a 35%-
    # selectivity filter doesn't get an unfiltered query's ef. This caps the
    # expansion — batched lockstep search cost scales ~linearly with ef, so
    # the cap is far below the reference's single-query 20k.
    ef_filtered_cap: int = 2048
    beam_width: int = 4
    flat_scan_dtype: str = "bf16"  # "bf16" (1-pass MXU scan + exact f32 rerank) | "f32" (3-pass HIGH scan)
    serve_compact: bool = False  # coded-table repack: half HBM, ~2x probes
    serve_refine: bool = True  # int16 pool-rescore plane (+2 B/dim/row HBM): recall to the pool bound
    serve_ivf_min_n: int = 4096  # min rows for a coded IVF serving table (below: pure graph walk)
    lexical_device: str = "auto"  # "auto" | "off": device BM25 snapshot for batched hybrid at >=50k docs
    store_codes: Any = False  # persist ivfq.* codes for cloud serving: False | True/"sq8" | "pq" | "opq"
    stream_transport: str = "sq8"  # beyond-HBM stream coding: "sq8" (1 B/dim) | "pq" (d/2 B/row, 128-pooled exact rerank)
    selectivity_cutoff: float = 0.30
    compact_gather_cutoff: float = 0.50  # <= this selectivity: gather eligible rows into a dense device sub-corpus (scan cost O(sel*N); dense rows also dodge the masked approx_min_k selection hazard, ops/topk.py)
    plan_gather_budget_bytes: int = 2 << 30  # total HBM the plan cache may hold in gathered sub-corpora (LRU-evicted)
    lexical: bool = False  # BM25 over insert(text=...)
    observer: Any = None  # MetricsObserver
    logger: Any = None  # logging.Logger (reference: WithLogger/slog, engine.go:158)
    commit_store: Any = None  # blobstore.s3.DDBCommitStore-style CAS commit plane
    seed: int = 42
    device: Any = "cuda"

    def __post_init__(self):
        self.device = checked_device(self.device, "EngineOptions")

    def to_config(self) -> dict:
        return {
            "dim": self.dim,
            "metric": self.metric.value,
            "quantizer": self.quantizer,
            "qparams": self.qparams,
            "schema": self.schema.to_dict() if self.schema else None,
            "lexical": self.lexical,
        }

    def apply_config(self, cfg: dict):
        self.dim = cfg["dim"]
        self.metric = Metric(cfg["metric"])
        self.quantizer = cfg.get("quantizer", "none")
        self.qparams = cfg.get("qparams", {})
        if cfg.get("schema"):
            self.schema = Schema.from_dict(cfg["schema"])
        self.lexical = cfg.get("lexical", False)


def _seg_blob(seg_id: int) -> str:
    return f"segment_{seg_id:06d}.vgt"


# Live docs from which hybrid_search_batch builds the device BM25 snapshot by
# itself (EngineOptions.lexical_device="auto"), as the JAX engine does.
DEVICE_LEXICAL_MIN_DOCS = 50_000

PK_SIDECAR = "PKCURRENT"  # {"version": N, "blob": "pk_%06d.ckpt"}


def _id_row_map(seg, rids: np.ndarray, old_rows: np.ndarray, n_old: int) -> np.ndarray:
    """Vectorized (old row -> new row) map for PK remapping after a segment
    write that may permute rows: row of id rids[i] in `seg` lands at
    row_map[old_rows[i]]; unmapped rows carry -1 (dropped)."""
    seg_ids = np.asarray(seg.ids, np.int64)
    rids = np.asarray(rids, np.int64)
    order = np.argsort(seg_ids, kind="stable")
    pos = np.searchsorted(seg_ids[order], rids)
    new_rows = order[np.clip(pos, 0, max(len(order) - 1, 0))] if len(order) else np.zeros(0, np.int64)
    ok = (pos < len(order)) & (seg_ids[new_rows] == rids) if len(order) else np.zeros(0, bool)
    row_map = np.full(n_old, -1, np.int64)
    row_map[np.asarray(old_rows)[ok]] = new_rows[ok]
    return row_map


_SEGMENT_CLASSES = {"flat": FlatSegment, "vamana": VamanaSegment}


def open_segment(store, info, options, verify_checksum: bool = True):
    """Open a committed segment: a zero-copy view where the store has one,
    else a lazy ranged-read open. Graph segments take the options' serving
    knobs (serve_refine, serve_compact)."""
    view_getter = getattr(store, "get_view", None)
    if view_getter is not None:
        data = view_getter(info.name)
        kind = container.parse_header(data)[0].get("kind")
    else:
        kind = container.LazyContainer(store, info.name, verify_checksum).meta.get("kind")
    cls = _SEGMENT_CLASSES.get(kind)
    if cls is None:
        raise ErrCorrupt(f"unknown segment kind {kind!r}")
    if view_getter is not None:
        seg = cls.open(data, info.seg_id, verify_checksum)
    else:
        seg = cls.open_lazy(store, info.name, info.seg_id, verify_checksum)
    return _serving_knobs(seg, options)


def _serving_knobs(seg, options):
    if isinstance(seg, VamanaSegment):
        seg.serve_compact = options.serve_compact
        seg.serve_refine = options.serve_refine
    return seg


class Engine:
    """The LSM engine on PyTorch (see module docstring)."""

    def __init__(self, store: BlobStore, options: EngineOptions):
        if not isinstance(options, EngineOptions):
            raise TypeError("vecgo_tpu_torch.Engine needs vecgo_tpu_torch EngineOptions")
        self.store = store
        self.options = options
        self.manifests = ManifestStore(store, commit_store=options.commit_store)
        self._lock = threading.RLock()
        self._closed = False
        self._lsn = 0
        self._committed_lsn = 0  # LSN recorded by the last manifest save
        self._next_id = 1
        self._next_seg_id = 1
        self._version = 0
        self.pk = PKIndex()
        self.memtable = MemTable(options.dim, options.metric)
        self._segments: List[SegmentHandle] = []
        self._tombstones = TombstoneSet()
        self._tracker = SnapshotTracker()
        self._log = options.logger or logging.getLogger("vecgo_tpu_torch.engine")
        # Host memtable backpressure (reference: 1 GB default engine.go:446).
        self._mem_controller = Controller(
            options.memory_limit_bytes, observer=options.observer
        )
        # HBM residency budget: over-budget segments stream (beyond-HBM tier).
        self._device_budget = (
            DeviceBudget(options.hbm_budget_bytes)
            if options.hbm_budget_bytes > 0
            else None
        )
        # (snapshot, filter) -> plan LRU: plans are snapshot-invariant, so
        # repeated batches skip the O(N) mask/strategy rebuild (search.py).
        self._plan_cache = search_mod.PlanCache()
        self._lexical = BM25Index() if options.lexical else None
        self._lexical_dev = None  # (version key, DeviceBM25) serving snapshot

    # ==================== open / recovery ====================

    @staticmethod
    def open(store, options: Optional[EngineOptions] = None, version: Optional[int] = None,
             as_of: Optional[float] = None, create: bool = False) -> "Engine":
        """Open or create a database (same store layout as the JAX engine)."""
        if isinstance(store, str):
            store = LocalStore(store)
        options = options or EngineOptions()
        ms = ManifestStore(store, commit_store=options.commit_store)
        time_travel = version is not None or as_of is not None
        if time_travel:
            options.read_only = True
        if not ms.exists():
            if not create and not time_travel:
                raise ErrNotFound("no database found (pass create=True)")
            if options.dim <= 0:
                raise ValueError("dim required to create a database")
            eng = Engine(store, options)
            eng._save_manifest(initial=True)
            return eng
        m = ms.load(version=version, as_of=as_of)
        options.apply_config(m.config)
        eng = Engine(store, options)
        eng._version = m.version
        eng._lsn = eng._committed_lsn = m.lsn
        eng._next_id = m.next_id
        eng._next_seg_id = m.next_seg_id
        for info in m.segments:
            seg = open_segment(store, info, options, options.verify_checksum)
            eng._segments.append(SegmentHandle(seg, info))
            if info.tombstone_blob:
                eng._tombstones.by_seg[info.seg_id] = SegmentTombstones.from_bytes(
                    store.get(info.tombstone_blob)
                )
        if not options.read_only:
            eng._gc_orphans()
        # The PK checkpoint counts only if it was written at this version.
        ckpt = m.pk_checkpoint
        if ckpt is None and store.exists(PK_SIDECAR):
            try:
                sc = json.loads(store.get(PK_SIDECAR))
                if sc.get("version") == m.version:
                    ckpt = sc.get("blob")
            except (ValueError, AttributeError):  # unreadable sidecar: rebuild
                ckpt = None
        if ckpt and store.exists(ckpt):
            eng.pk = PKIndex.from_checkpoint(store.get(ckpt))
        else:
            eng._rebuild_pk()
        if eng._lexical is not None:
            eng._rebuild_lexical()
        eng._log.info("open: version=%d segments=%d lsn=%d", eng._version,
                      len(eng._segments), eng._lsn)
        return eng

    def _gc_orphans(self, grace_s: Optional[float] = None):
        """Delete segment blobs referenced by NO manifest version.

        Age-gated: a second writer mid-commit has PUT its segment blob but not
        yet saved the manifest — deleting young unreferenced blobs would
        corrupt that in-flight commit (the manifest-CAS multi-writer window).
        Blobs without a known mtime are left alone here; vacuum() reclaims
        them explicitly.
        """
        if grace_s is None:
            grace_s = self.options.orphan_gc_grace_s
        referenced = set()
        for v in self.manifests.list_versions():
            m = self.manifests.load(v)
            for s in m.segments:
                referenced.add(s.name)
                if s.tombstone_blob:
                    referenced.add(s.tombstone_blob)
            if m.pk_checkpoint:
                referenced.add(m.pk_checkpoint)
        mtime = getattr(self.store, "mtime", None)
        now = time.time()
        for name in self.store.list("segment_"):
            if name in referenced:
                continue
            if grace_s > 0:
                if mtime is None:
                    continue
                try:
                    age = now - mtime(name)
                except ErrNotFound:
                    continue
                if age < grace_s:
                    continue
            self.store.delete(name)

    def _rebuild_pk(self):
        """Vectorized PK rebuild (reference engine.go:620-712): per-segment
        sorted blocks for single-version ids; explicit chains (with the real
        per-row delete LSNs) for updated/tombstoned ids."""
        self.pk = PKIndex.rebuild_from_segments(
            [h.segment for h in self._segments], self._tombstones
        )

    def _rebuild_lexical(self):
        """BM25 rebuild on open. "_text" is an ordinary interned STRING
        column in the segment's ColumnarMeta (insert_batch folds it into the
        doc), so presence is an O(1) column lookup and the text itself comes
        from the interned value table. Only the row the PK index sees for an
        id is indexed: the JAX engine indexes every row with text, so after
        a reopen a deleted doc (or an id's older version) scores again and
        hybrid_search_batch returns it (ROADMAP.md §3)."""
        for h in self._segments:
            seg = h.segment
            codes = seg.cm.str_codes.get("_text")
            if codes is None:
                continue
            values = seg.cm.str_values["_text"]
            ids = seg.ids
            for row in np.flatnonzero(codes >= 0):
                rid = int(ids[row])
                ent = self.pk.get_entry(rid)
                if ent is not None and ent[1] == h.seg_id and ent[2] == row:
                    self._lexical.add(rid, values[int(codes[row])])

    # ==================== snapshots ====================

    def snapshot(self) -> Snapshot:
        with self._lock:
            return Snapshot(
                lsn=self._lsn,
                version=self._version,
                memtable=self.memtable,
                mem_rows=len(self.memtable),
                segments=tuple(self._segments),
                tombstones=self._tombstones,
            ).acquire()

    # ==================== CRUD ====================

    def _check_writable(self):
        if self._closed:
            raise ErrClosed("engine is closed")
        if self.options.read_only:
            raise ErrReadOnly("read-only (reader mode or time travel)")

    def insert(self, vector, metadata=None, payload=None, text=None, id=None) -> int:
        """Insert one record; returns its id (reference: Insert engine.go:833)."""
        return self.insert_batch(
            np.asarray(vector, np.float32)[None, :],
            [metadata],
            [payload],
            [text] if text is not None else None,
            [id] if id is not None else None,
        )[0]

    def insert_batch(
        self,
        vectors,
        metadatas=None,
        payloads=None,
        texts=None,
        ids=None,
    ) -> List[int]:
        """Atomic batch insert (reference: BatchInsert :935, WriteBatch batch.go).

        This is also the bulk path (the reference's deferred mode,
        BatchInsertDeferred :1066, is simply the only mode: L0 has no graph to
        maintain on TPU). Auto-id batches without text/schema take a fully
        vectorized route: one memtable slab write + one PK block — O(1) host
        work per batch instead of per row (millions of rows/s)."""
        self._check_writable()
        vectors = np.asarray(vectors, np.float32)
        if vectors.ndim != 2 or vectors.shape[1] != self.options.dim:
            raise ErrDimensionMismatch(
                f"batch shape {vectors.shape}, want [*, {self.options.dim}]"
            )
        n = vectors.shape[0]
        schema = self.options.schema
        explicit_bulk_ids = None
        if (
            ids is not None
            and texts is None
            and schema is None
            and self._lexical is None
            and n >= 2
        ):
            # Explicit ids ride the vectorized path when strictly increasing
            # and fresh (never seen) — the common bulk-load shape. Updates or
            # unsorted ids fall back to the per-row MVCC path.
            cand_ids = np.asarray(ids, np.int64)
            if (
                len(cand_ids) == n
                and (np.diff(cand_ids) > 0).all()
                and not self.pk.contains_any_sorted(cand_ids)
            ):
                explicit_bulk_ids = cand_ids
        bulk = (
            (ids is None or explicit_bulk_ids is not None)
            and texts is None
            and schema is None
            and self._lexical is None
            and n >= 2
        )
        row_bytes = self.options.dim * 4 + 64
        if self.options.metric == Metric.HAMMING:
            # Hamming vectors are 0/1-encoded (distance == squared L2 exactly).
            if not np.isin(vectors, (0.0, 1.0)).all():
                raise ErrInvalidVector("hamming metric requires 0/1 vectors")
        if bulk:
            if self.options.metric == Metric.COSINE:
                # Cosine normalization inside insert_block materializes the
                # slab itself; validate with the allocation-free reduction
                # scan (np.isfinite(x).all() would materialize a full-size
                # bool array — utils/hostmem module doc).
                if not all_finite(vectors):
                    raise ErrInvalidVector("batch contains NaN/Inf")
                precopied = False
            else:
                # Fused copy+validate: the defensive slab copy and the
                # finiteness check share one pass (validation reads each
                # chunk cache-hot right after it is written). Done OUTSIDE
                # the engine lock — the copy is the bulk path's biggest cost.
                vectors = copy_validate(vectors)
                precopied = True
            self._mem_controller.acquire(n * row_bytes)
            new_ids = None
            with self._lock:
                if explicit_bulk_ids is not None and self.pk.contains_any_sorted(
                    explicit_bulk_ids
                ):
                    # TOCTOU guard: the pre-lock freshness gate raced with a
                    # concurrent insert of the same ids. Bulk upsert_block
                    # would violate the one-block-per-id PK invariant, so fall
                    # back to the per-row MVCC path below. The recheck runs
                    # under the SAME lock acquisition as upsert_block.
                    bulk = False
                else:
                    if explicit_bulk_ids is not None:
                        id0 = int(explicit_bulk_ids[0])
                        self._next_id = max(
                            self._next_id, int(explicit_bulk_ids[-1]) + 1
                        )
                        new_ids = explicit_bulk_ids
                    else:
                        id0 = self._next_id
                        self._next_id += n
                        new_ids = huge_arange(id0, n)
                    lsn0 = self._lsn + 1
                    self._lsn += n
                    row0 = self.memtable.insert_block(
                        vectors, id0, lsn0, metadatas, payloads,
                        ids=new_ids, precopied=precopied,
                    )
                    self.pk.upsert_block(
                        new_ids,
                        MEMTABLE_SEG,
                        huge_arange(row0, n),
                        lsn0,
                    )
                    obs = self.options.observer
                    if obs is not None:
                        obs.on_insert(n)
                        obs.on_memtable_status(
                            len(self.memtable), self._mem_controller.used
                        )
            if bulk:
                if (
                    self.options.auto_flush
                    and len(self.memtable) >= self.options.flush_threshold
                ):
                    self.commit()
                return new_ids.tolist()
            # Lost the race: hand the reservation back (the per-row path
            # below takes its own) and fall through.
            self._mem_controller.release(n * row_bytes)
        out = []
        self._mem_controller.acquire(n * row_bytes)
        with self._lock:
            for i in range(n):
                md = metadatas[i] if metadatas is not None else None
                if schema is not None:
                    schema.validate(md)
                text = texts[i] if texts is not None else None
                if text is not None:
                    md = dict(md or {})
                    md["_text"] = text
                rid = int(ids[i]) if ids is not None else self._next_id
                self._next_id = max(self._next_id, rid + 1)
                self._lsn += 1
                lsn = self._lsn
                # Upsert semantics: tombstone any currently-visible old row.
                old = self.pk.get_entry(rid)
                if old is not None and old[1] != DELETED:
                    self._apply_tombstone(old[1], old[2], lsn)
                row = self.memtable.insert(
                    vectors[i],
                    rid,
                    lsn,
                    md,
                    payloads[i] if payloads is not None else None,
                )
                self.pk.upsert(rid, MEMTABLE_SEG, row, lsn)
                if text is not None and self._lexical is not None:
                    self._lexical.add(rid, text)
                out.append(rid)
            obs = self.options.observer
            if obs is not None:
                obs.on_insert(n)
                obs.on_memtable_status(
                    len(self.memtable), self._mem_controller.used
                )
        if self.options.auto_flush and len(self.memtable) >= self.options.flush_threshold:
            self.commit()
        return out

    def _apply_tombstone(self, seg_id: int, row: int, lsn: int):
        if seg_id == MEMTABLE_SEG:
            self.memtable.mark_deleted(row, lsn)
        else:
            seg = self._segment_by_id(seg_id)
            self._tombstones = self._tombstones.with_delete(seg_id, row, lsn, seg.n)

    def delete(self, id: int) -> bool:
        """Delete by id (reference: Delete engine.go:1186)."""
        self._check_writable()
        with self._lock:
            ent = self.pk.get_entry(int(id))
            if ent is None or ent[1] == DELETED:
                return False
            self._lsn += 1
            self._apply_tombstone(ent[1], ent[2], self._lsn)
            self.pk.delete(int(id), self._lsn)
            if self._lexical is not None:
                self._lexical.delete(int(id))
            obs = self.options.observer
            if obs is not None:
                obs.on_delete(1)
            return True

    def get(self, id: int) -> Candidate:
        """Point lookup (reference: Get engine.go:1638)."""
        if self._closed:
            raise ErrClosed("engine is closed")
        obs = self.options.observer
        with self._lock:
            ent = self.pk.get_entry(int(id))
            if ent is None or ent[1] == DELETED:
                raise ErrNotFound(f"id {id}")
            _, seg_id, row = ent
            if seg_id == MEMTABLE_SEG:
                mem = self.memtable
                if obs is not None:
                    obs.on_get(1)
                return Candidate(
                    id=int(id), distance=0.0, metadata=mem.doc(row),
                    payload=mem.payload(row), vector=mem.vector(row).copy(),
                )
            seg = self._segment_by_id(seg_id)
        if obs is not None:
            obs.on_get(1)
        return Candidate(
            id=int(id), distance=0.0, metadata=seg.doc(row),
            payload=seg.payload(row), vector=seg.vector(row).copy(),
        )

    def _segment_by_id(self, seg_id: int):
        for h in self._segments:
            if h.seg_id == seg_id:
                return h.segment
        raise ErrNotFound(f"segment {seg_id}")

    def scan(self):
        """Yield all visible records in id order (reference: Scan engine.go:1393)."""
        # Capture the PK entries under the same lock as the snapshot: a
        # concurrent flush/compaction remaps live PK entries to segments the
        # snapshot doesn't hold, which would silently drop rows.
        with self._lock:
            snap = self.snapshot()
            entries = sorted(self.pk.scan(snap.lsn))
        try:
            for id, seg_id, row in entries:
                if seg_id == MEMTABLE_SEG:
                    if row >= snap.mem_rows:
                        continue
                    mem = snap.memtable
                    yield Candidate(
                        id=id, distance=0.0, metadata=mem.doc(row),
                        payload=mem.payload(row), vector=mem.vector(row).copy(),
                    )
                else:
                    try:
                        seg = search_mod._seg_by_id(snap, seg_id)
                    except KeyError:
                        continue
                    yield Candidate(
                        id=id, distance=0.0, metadata=seg.doc(row),
                        payload=seg.payload(row), vector=seg.vector(row).copy(),
                    )
        finally:
            snap.release()

    # ==================== search ====================

    def search(self, q, k: int = 10, **kw) -> SearchResult:
        """Single-query search; kw fields mirror SearchOptions."""
        res = self.search_batch(np.asarray(q, np.float32)[None, :], k, **kw)
        return res[0]

    def _search_options(self, k: int, kw: dict) -> SearchOptions:
        if self._closed:
            raise ErrClosed("engine is closed")
        opts = SearchOptions(k=k)
        for key, val in kw.items():
            if not hasattr(opts, key):
                raise TypeError(f"unknown search option {key!r}")
            setattr(opts, key, val)
        opts.selectivity_cutoff = kw.get("selectivity_cutoff", self.options.selectivity_cutoff)
        return opts

    def _queries(self, qs):
        """Query batch as given (numpy or tensor), checked for shape."""
        if not isinstance(qs, torch.Tensor):
            qs = np.asarray(qs, np.float32)
        if qs.ndim != 2 or qs.shape[1] != self.options.dim:
            raise ErrDimensionMismatch(f"query shape {tuple(qs.shape)}")
        return qs

    def _snapshot_search(self, qs, opts, need_locations: bool, materialize=None):
        """Search a fresh snapshot; `materialize(snap, result)`, if given,
        runs while the snapshot is still held."""
        snap = self.snapshot()
        self._tracker.register(snap)
        t0 = time.time()
        try:
            out = search_mod.search_snapshot(
                snap, self.pk, qs, opts, self.options,
                device_budget=self._device_budget, need_locations=need_locations,
                plan_cache=self._plan_cache,
            )
            if self.options.observer is not None:
                self.options.observer.on_search(qs.shape[0], time.time() - t0)
            return materialize(snap, out) if materialize else out
        finally:
            self._tracker.unregister(snap)
            snap.release()

    def search_arrays(self, qs, k: int = 10, **kw):
        """Bulk search returning (ids [B, k] int64, dists [B, k] f32) arrays;
        accepts numpy arrays or tensors (device-resident queries stay there)."""
        opts = self._search_options(k, kw)
        ids, dists, _, _ = self._snapshot_search(self._queries(qs), opts, False)
        return ids, dists

    def search_batch(self, qs, k: int = 10, **kw) -> list:
        """Batched search materializing Candidates (metadata, payload and,
        with with_vectors, the vector)."""
        opts = self._search_options(k, kw)
        qs = self._queries(qs)

        def materialize(snap, out):
            ids, dists, locs, stats = out
            results = []
            for bi in range(qs.shape[0]):
                cands = []
                for j in range(opts.k):
                    if ids[bi, j] < 0:
                        break
                    c = Candidate(id=int(ids[bi, j]), distance=float(dists[bi, j]))
                    if not opts.without_data:
                        seg_id, row = locs[bi][j]
                        src = snap.memtable if seg_id == -1 else search_mod._seg_by_id(snap, seg_id)
                        c.metadata = src.doc(row)
                        c.payload = src.payload(row)
                        if opts.with_vectors:
                            c.vector = src.vector(row).copy()
                    cands.append(c)
                results.append(SearchResult(candidates=cands, stats=stats))
            return results

        return self._snapshot_search(qs, opts, True, materialize)

    def search_arrays_stream(self, batches, k: int = 10, depth: int = 3, **kw):
        """Sustained serving over ONE snapshot, keeping up to `depth` batches
        enqueued on the device; yields (ids, dists) per batch in input order.
        The snapshot stays registered until the generator finishes or closes."""
        opts = self._search_options(k, kw)
        snap = self.snapshot()
        self._tracker.register(snap)

        def _run():
            t0 = time.time()
            nq = 0
            try:
                for ids, dists, _, _ in search_mod.search_snapshot_stream(
                    snap, self.pk, (self._queries(q) for q in batches), opts,
                    self.options, device_budget=self._device_budget,
                    need_locations=False, depth=depth, plan_cache=self._plan_cache,
                ):
                    nq += ids.shape[0]
                    yield ids, dists
                if self.options.observer is not None and nq:
                    self.options.observer.on_search(nq, time.time() - t0)
            finally:
                self._tracker.unregister(snap)
                snap.release()

        return _run()

    def hybrid_search(
        self, q, text: str, k: int = 10, rrf_k: int = 60, pool: int = 0, **kw
    ) -> SearchResult:
        """Vector + BM25 with RRF fusion (reference: HybridSearch engine.go:1538
        — vector top-2k + lexical top-2k -> 1/(rrfK+rank) merge).

        `pool` controls the per-modality rank window (default 2k, min 20).
        Vector hits reuse their already-materialized candidates; only
        lexical-only ids pay a point lookup."""
        if self._lexical is None:
            raise ValueError("lexical index not enabled (EngineOptions.lexical)")
        pool = pool or max(2 * k, 20)
        vres = self.search(q, pool, **kw)
        lres = self._lexical.search(text, pool)
        scores: Dict[int, float] = {}
        vmap: Dict[int, Candidate] = {}
        for rank, c in enumerate(vres.candidates):
            scores[c.id] = scores.get(c.id, 0.0) + 1.0 / (rrf_k + rank + 1)
            vmap[c.id] = c
        for rank, (id, _) in enumerate(lres):
            scores[id] = scores.get(id, 0.0) + 1.0 / (rrf_k + rank + 1)
        # Deterministic tie-break (score desc, id asc) — matches the batched
        # path's vectorized fusion exactly.
        top = sorted(scores.items(), key=lambda kv: (-kv[1], kv[0]))[:k]
        out = []
        for id, s in top:
            c = vmap.get(id)
            if c is None:  # lexical-only hit: one point lookup
                try:
                    c = self.get(id)
                except ErrNotFound:
                    continue
            c.distance = -s  # smaller-is-better convention
            out.append(c)
        return SearchResult(candidates=out)

    def enable_device_lexical(self, max_hot_terms: int = 4096, min_df: int = 8):
        """Build the device-resident BM25 serving snapshot (lexical/device_bm25):
        hot-vocabulary BM25 weights as an [n_docs, H] bf16 table on the
        options' device, swept by `scan_topk`, with an exact-f32 pool rescore.
        Used automatically by hybrid_search_batch while the engine version is
        unchanged; call again after writes to refresh. Returns the DeviceBM25."""
        if self._lexical is None:
            raise ValueError("lexical index not enabled (EngineOptions.lexical)")
        snap = DeviceBM25(self._lexical, max_hot_terms=max_hot_terms, min_df=min_df,
                          device=self.options.device)
        self._lexical_dev = ((self._version, self._lsn), snap)
        return snap

    def hybrid_search_batch(
        self, qs, texts, k: int = 10, rrf_k: int = 60, pool: int = 0, **kw
    ):
        """Batched hybrid search: ONE batched vector search (search_arrays)
        + ONE batched BM25 pass + vectorized RRF fusion (the single-query
        `hybrid_search` is a host loop; this is the serving path). Returns
        (ids [B, k] int64 with -1 padding, scores [B, k] f32, HIGHER is
        better — RRF mass, not a distance).

        Reference: HybridSearch engine.go:1538 fuses vector top-2k + lexical
        top-2k with 1/(rrfK+rank); this computes the identical fusion for a
        whole query batch in a handful of numpy ops."""
        if self._lexical is None:
            raise ValueError("lexical index not enabled (EngineOptions.lexical)")
        if len(texts) != (qs.shape[0] if hasattr(qs, "shape") else len(qs)):
            raise ValueError("texts/queries length mismatch")
        pool = pool or max(2 * k, 20)
        vids, _ = self.search_arrays(qs, k=pool, **kw)  # [B, pool] int64
        b = vids.shape[0]
        dev = self._lexical_dev
        if (
            (dev is None or dev[0] != (self._version, self._lsn))
            and self.options.lexical_device == "auto"
            and len(self._lexical) >= DEVICE_LEXICAL_MIN_DOCS
        ):
            # Auto-build the device serving snapshot: at this corpus size the
            # dense exact host batch costs seconds per call while the device
            # sweep costs milliseconds; rebuild happens at most once per
            # write->search transition (keyed to (version, lsn)).
            self.enable_device_lexical()
            dev = self._lexical_dev
        if dev is not None and dev[0] == (self._version, self._lsn):
            # Device-resident BM25 (enable_device_lexical): one scan_topk sweep
            # + exact rescore; rare-term queries merge host-side inside. Array
            # contract — no per-hit python.
            lids, _ = dev[1].search_batch_arrays(list(texts), pool)
            if lids.shape[1] < pool:
                lids = np.pad(
                    lids, ((0, 0), (0, pool - lids.shape[1])),
                    constant_values=-1,
                )
        else:
            lres = self._lexical.search_batch(list(texts), pool)
            lids = np.full((b, pool), -1, np.int64)
            for bi, hits in enumerate(lres):
                for r, (id_, _) in enumerate(hits):
                    lids[bi, r] = id_
        # f64 rank weights + f64 segment sums: bit-identical RRF mass to the
        # single-query path (within a row, entries sort stably to vector-
        # before-lexical, rank ascending — the same accumulation order).
        rank_w = 1.0 / (rrf_k + np.arange(pool, dtype=np.float64) + 1.0)
        all_ids = np.concatenate([vids, lids], axis=1)  # [B, 2P]
        all_sc = np.concatenate(
            [
                np.where(vids >= 0, rank_w[None, :], 0.0),
                np.where(lids >= 0, rank_w[None, :], 0.0),
            ],
            axis=1,
        )
        # Vectorized dedup-sum per row: sort by id; an id appears at most
        # ONCE per modality (per-row ids are unique within each list), so a
        # run of equal ids has length <= 2 and the fused mass is an exact
        # two-addend f64 sum — bit-identical to the single-query path.
        order = np.argsort(all_ids, axis=1, kind="stable")
        sid = np.take_along_axis(all_ids, order, axis=1)
        ssc = np.take_along_axis(all_sc, order, axis=1)
        w = sid.shape[1]
        newseg = np.ones((b, w), bool)
        newseg[:, 1:] = sid[:, 1:] != sid[:, :-1]
        endseg = np.ones((b, w), bool)
        endseg[:, :-1] = newseg[:, 1:]
        prev = np.zeros_like(ssc)
        prev[:, 1:] = np.where(~newseg[:, 1:], ssc[:, :-1], 0.0)
        seg_sum = ssc + prev
        fused = np.where(endseg & (sid >= 0), seg_sum, -1.0)
        kk = min(k, w)
        # Full row sort by (score desc, id asc): w = 2*pool is small, and the
        # id tie-break matches the single-query path deterministically.
        top = np.lexsort((sid, -fused), axis=1)[:, :kk]
        tv = np.take_along_axis(fused, top, axis=1)
        out_ids = np.full((b, k), -1, np.int64)
        out_sc = np.zeros((b, k), np.float32)
        got = tv > 0
        out_ids[:, :kk] = np.where(
            got, np.take_along_axis(sid, top, axis=1), -1
        )
        out_sc[:, :kk] = np.where(got, tv, 0.0)
        return out_ids, out_sc

    def sharded_searcher(self, mesh):
        """Row-shard the committed snapshot across a device grid
        (`parallel.mesh.make_mesh`) and return its exact searcher
        (`parallel.engine_shard.ShardedSnapshotSearcher`; the memtable is
        not included, as in the JAX engine)."""
        from vecgo_tpu_torch.parallel.engine_shard import ShardedSnapshotSearcher

        snap = self.snapshot()
        try:
            return ShardedSnapshotSearcher(snap, mesh, self.options.metric)
        finally:
            snap.release()

    # ==================== durability ====================

    def commit(self) -> int:
        """Flush the memtable into an immutable flat segment and save the
        manifest (the JAX engine's commit, with the port's classes)."""
        self._check_writable()
        with self._lock:
            mem = self.memtable
            n = len(mem)
            if n == 0 and not self._tombstones.by_seg:
                return self._version
            t0 = time.time()
            new_handle = None
            if n:
                seg_id = self._next_seg_id
                opt = self.options
                writer = FlatWriter(
                    opt.dim, opt.metric, quantizer=opt.quantizer, qparams=opt.qparams,
                    ivf_partitions=(
                        n // opt.ivf_rows_per_partition
                        if opt.flush_ivf_partitions and n >= 2 * opt.ivf_rows_per_partition
                        else 0
                    ),
                    seed=opt.seed, compress=opt.compress_segments, device=opt.device,
                )
                live_rows, vecs, rids, lsns, docs, pays = mem.export_live()
                writer.add_batch(vecs, rids, docs, pays, lsns)
                data = writer.finish()
                blob_name = _seg_blob(seg_id)
                self.store.put(blob_name, data)
                seg = FlatSegment.open(data, seg_id, verify_checksum=False)
                row_map = _id_row_map(seg, rids, live_rows, len(mem))
                info = SegmentInfo(name=blob_name, seg_id=seg_id, kind="flat", level=0,
                                   row_count=seg.n, stats=seg.meta.get("stats", {}))
                new_handle = SegmentHandle(seg, info)
                self._next_seg_id += 1
                self.pk.remap_bulk(MEMTABLE_SEG, seg_id, row_map)
            version = self._version + 1
            for h in self._segments:
                ts = self._tombstones.by_seg.get(h.seg_id)
                if ts is not None and len(ts.rows):
                    tname = f"segment_{h.seg_id:06d}.v{version}.tomb"
                    self.store.put(tname, ts.to_bytes())
                    h.info.tombstone_blob = tname
            if new_handle is not None:
                self._segments.append(new_handle)
                self.memtable = MemTable(self.options.dim, self.options.metric)
                self._mem_controller.set_used(0)
            self._version = version
            self._save_manifest()
            self._plan_cache.clear()
            self.pk.compact_chains(self._tracker.min_live_lsn(self._lsn))
            if self.options.observer is not None:
                self.options.observer.on_flush(n, time.time() - t0)
            self._log.info("commit: version=%d rows=%d dur=%.3fs", self._version, n,
                           time.time() - t0)
        if self.options.auto_compact:
            self.compact_if_needed()
        return self._version

    def _save_manifest(self, initial: bool = False):
        m = Manifest(
            version=self._version,
            lsn=self._lsn,
            next_id=self._next_id,
            next_seg_id=self._next_seg_id,
            segments=[h.info for h in self._segments],
            config=self.options.to_config(),
        )
        self.manifests.save(m)
        self._committed_lsn = m.lsn

    # ==================== compaction ====================

    def pick_compaction(self) -> Optional[List[int]]:
        """Delegate to the configured policy (reference: policy.Pick)."""
        policy = self.options.compaction_policy or SizeTieredPolicy(
            threshold=self.options.compaction_threshold
        )
        views = [
            SegmentView(
                seg_id=h.seg_id,
                level=h.info.level,
                rows=h.segment.n,
                live_rows=h.segment.n - self._tombstones.count(h.seg_id),
            )
            for h in self._segments
        ]
        picked = policy.pick(views)
        return picked if picked else None

    def compact_if_needed(self) -> bool:
        picked = self.pick_compaction()
        if picked:
            self.compact(picked)
            return True
        return False

    def compact(self, seg_ids: Optional[List[int]] = None) -> Optional[int]:
        """Merge segments (the JAX engine's compaction with the port's
        writers): P1 snapshots the inputs under the lock; P2 merges and
        writes without it, into a Vamana segment built on the options'
        device at >= graph_threshold live rows, else a flat segment; P3
        swaps under the lock, remapping deletes that arrived after P1 and
        the PK index onto the new segment."""
        self._check_writable()
        opt = self.options
        with self._lock:
            if seg_ids is None:
                seg_ids = self.pick_compaction()
                if not seg_ids:
                    return None
            inputs = [h for h in self._segments if h.seg_id in set(seg_ids)]
            if not inputs:
                return None
            snapshot_lsn = self._lsn
            tombstones = self._tombstones
            out_seg_id = self._next_seg_id
            self._next_seg_id += 1

        # ---- P2: merge without the lock ----
        total_live = sum(h.segment.n - tombstones.count(h.seg_id, snapshot_lsn) for h in inputs)
        if total_live >= opt.graph_threshold:
            writer = VamanaWriter(
                opt.dim, opt.metric, device=opt.device, r=opt.graph_r,
                l_build=opt.graph_l_build, alpha=opt.graph_alpha,
                build_mode=opt.graph_build_mode, build_params=opt.graph_build_params,
                quantizer=opt.quantizer, qparams=opt.qparams, seed=opt.seed,
                compress=opt.compress_segments, store_codes=opt.store_codes,
                ivf_min_n=opt.serve_ivf_min_n,
            )
            kind = "vamana"
        else:
            writer = FlatWriter(
                opt.dim, opt.metric, quantizer=opt.quantizer, qparams=opt.qparams,
                ivf_partitions=(
                    total_live // opt.ivf_rows_per_partition
                    if total_live >= 2 * opt.ivf_rows_per_partition else 0
                ),
                seed=opt.seed, compress=opt.compress_segments, device=opt.device,
            )
            kind = "flat"
        # Docs, payloads and metadata move as CSR slabs unless the inputs
        # disagree on a column's kind; then they move row by row.
        kinds: dict = {}
        slabs_ok = True
        for h in inputs:
            for f, kd in h.segment.cm.field_kinds().items():
                if kinds.setdefault(f, kd) != kd:
                    slabs_ok = False
        live_info = []  # (old_seg_id, live_rows, live_ids, n_old)
        cm_parts, docs_parts, pay_parts = [], [], []
        t0 = time.time()
        for h in inputs:
            seg = h.segment
            dead = tombstones.deleted_mask(seg.seg_id, seg.n, snapshot_lsn)
            live = np.arange(seg.n) if dead is None else np.flatnonzero(~dead)
            rids = np.asarray(seg.ids, np.int64)[live]
            docs = pays = None
            if slabs_ok:
                seg._ensure_blob("docs")
                seg._ensure_blob("payload")
                cm_parts.append(seg.cm.select(live))
                docs_parts.append(csr_select(seg._docs_data, seg._docs_indptr, live)
                                  + (len(live),))
                pay_parts.append(csr_select(seg._payload_data, seg._payload_indptr, live)
                                 + (len(live),))
            else:
                docs = [seg.doc(int(r)) for r in live]
                pays = [seg.payload(int(r)) for r in live]
            writer.add_batch(np.asarray(seg.vectors)[live], rids, docs, pays,
                             np.asarray(seg.lsns, np.int64)[live])
            live_info.append((seg.seg_id, live, rids, seg.n))
        if slabs_ok:
            writer.set_preset_rows(ColumnarMeta.concat(cm_parts), csr_concat(docs_parts),
                                   csr_concat(pay_parts))
        t_build = time.time()
        data = writer.finish()
        obs = opt.observer
        if obs is not None and kind == "vamana":
            obs.on_build(writer.row_count, time.time() - t_build)
        blob_name = _seg_blob(out_seg_id)
        self.store.put(blob_name, data)
        cls = VamanaSegment if kind == "vamana" else FlatSegment
        out_seg = _serving_knobs(cls.open(data, out_seg_id, verify_checksum=False), opt)

        # ---- P3: swap under the lock ----
        with self._lock:
            live_ids = {h.seg_id for h in self._segments}
            if not all(h.seg_id in live_ids for h in inputs):
                self.store.delete(blob_name)  # inputs vanished (concurrent compaction)
                return None
            row_maps = {
                old_seg: _id_row_map(out_seg, rids, live, n_old)
                for old_seg, live, rids, n_old in live_info
            }
            info = SegmentInfo(
                name=blob_name, seg_id=out_seg_id, kind=kind,
                level=max(h.info.level for h in inputs) + 1, row_count=out_seg.n,
                stats=out_seg.meta.get("stats", {}),
            )
            gone = {h.seg_id for h in inputs}
            self._segments = [h for h in self._segments if h.seg_id not in gone] + [
                SegmentHandle(out_seg, info)]
            # Deletes that arrived after P1 refer to rows copied into the
            # output: move them onto the new segment.
            tb = dict(self._tombstones.by_seg)
            late_rows, late_lsns = [], []
            for h in inputs:
                ts = tb.pop(h.seg_id, None)
                if ts is None:
                    continue
                rm = row_maps[h.seg_id]
                for row, lsn in zip(ts.rows, ts.lsns):
                    if lsn > snapshot_lsn:
                        new_row = int(rm[int(row)]) if int(row) < len(rm) else -1
                        if new_row >= 0:
                            late_rows.append(new_row)
                            late_lsns.append(int(lsn))
            if late_rows:
                tb[out_seg_id] = SegmentTombstones(out_seg.n, late_rows, late_lsns)
            self._tombstones = TombstoneSet(tb)
            for old_seg, rm in row_maps.items():
                self.pk.remap_bulk(old_seg, out_seg_id, rm)
            self._version += 1
            self._save_manifest()
            self._plan_cache.clear()
            for h in inputs:
                h.mark_obsolete()
            if obs is not None:
                obs.on_compaction(len(inputs), out_seg.n, time.time() - t0)
        self._log.info("compact: %d segments -> seg %d (%s, %d rows) dur=%.3fs",
                       len(inputs), out_seg_id, kind, out_seg.n, time.time() - t0)
        return self._version

    # ==================== write batch ====================

    def write_batch(self) -> "WriteBatch":
        """Atomic multi-op batch (reference: WriteBatch batch.go:31)."""
        return WriteBatch(self)

    # ==================== background loops ====================

    def start_background(self):
        """Start flush + compaction threads (reference: runFlushLoop
        engine.go:2313, runCompactionLoop :2329; GoSafe panic trap safe.go:11)."""
        if getattr(self, "_bg_stop", None) is not None:
            return
        self._bg_stop = threading.Event()
        self._compact_signal = threading.Event()

        def _safe(fn):
            # GoSafe analogue: a crashed background loop must not kill the engine.
            def run():
                while not self._bg_stop.is_set():
                    try:
                        fn()
                    except Exception:
                        logging.getLogger("vecgo_tpu_torch").exception(
                            "background task failed"
                        )
                        self._bg_stop.wait(1.0)

            return run

        def flush_loop():
            self._bg_stop.wait(self.options.flush_interval_s)
            if self._bg_stop.is_set():
                return
            obs = self.options.observer
            if obs is not None:
                # Queue depth = pending background work units (reference
                # OnQueueDepth): a due flush + a due compaction.
                depth = int(len(self.memtable) >= self.options.flush_threshold)
                depth += int(bool(self.pick_compaction()))
                obs.on_queue_depth(depth)
            if len(self.memtable) >= self.options.flush_threshold:
                self.commit()
                self._compact_signal.set()

        def compact_loop():
            self._compact_signal.wait(self.options.flush_interval_s)
            self._compact_signal.clear()
            if self._bg_stop.is_set():
                return
            self.compact_if_needed()

        self._bg_threads = [
            threading.Thread(target=_safe(flush_loop), daemon=True, name="vecgo-flush"),
            threading.Thread(target=_safe(compact_loop), daemon=True, name="vecgo-compact"),
        ]
        for t in self._bg_threads:
            t.start()

    def stop_background(self):
        stop = getattr(self, "_bg_stop", None)
        if stop is None:
            return
        stop.set()
        getattr(self, "_compact_signal", threading.Event()).set()
        for t in getattr(self, "_bg_threads", []):
            t.join(timeout=10)
        self._bg_stop = None

    # ==================== vacuum / time travel ====================

    def vacuum(self) -> dict:
        """Reclaim unreferenced manifests + blobs (reference: Vacuum :1979)."""
        self._check_writable()
        with self._lock:
            referenced, deleted_versions = self.manifests.vacuum(
                self.options.retention_versions, self.options.retention_duration_s
            )
            # The PKCURRENT sidecar references a checkpoint blob outside any
            # manifest; keep it if it matches a retained version.
            if self.store.exists(PK_SIDECAR):
                try:
                    sc = json.loads(self.store.get(PK_SIDECAR))
                    if sc.get("blob"):
                        referenced.add(sc["blob"])
                except Exception:
                    pass
            deleted_blobs = []
            live = {h.info.name for h in self._segments}
            for name in self.store.list("segment_"):
                if name not in referenced and name not in live:
                    self.store.delete(name)
                    deleted_blobs.append(name)
            for name in self.store.list("pk_"):
                if name not in referenced:
                    self.store.delete(name)
            self._log.info(
                "vacuum: deleted %d versions, %d blobs",
                len(deleted_versions), len(deleted_blobs),
            )
            return {
                "deleted_versions": deleted_versions,
                "deleted_blobs": deleted_blobs,
            }

    def versions(self) -> List[int]:
        return self.manifests.list_versions()

    # ==================== introspection / lifecycle ====================

    def stats(self) -> dict:
        """Reference: Stats engine.go:2134, DebugInfo, SegmentInfo."""
        with self._lock:
            seg_rows = sum(h.segment.n for h in self._segments)
            dead = sum(
                self._tombstones.count(h.seg_id) for h in self._segments
            )
            mem_dead = self.memtable.deleted_mask(len(self.memtable))
            dead += int(mem_dead.sum()) if mem_dead is not None else 0
            return {
                "version": self._version,
                "lsn": self._lsn,
                "next_id": self._next_id,
                "memtable_rows": len(self.memtable),
                "segments": [
                    {
                        "seg_id": h.seg_id,
                        "kind": h.info.kind,
                        "rows": h.segment.n,
                        "level": h.info.level,
                        "tombstones": self._tombstones.count(h.seg_id),
                    }
                    for h in self._segments
                ],
                "segment_rows": seg_rows,
                "tombstoned_rows": dead,
                "live_rows": len(self.memtable) + seg_rows - dead,
                "pk_entries": len(self.pk),
                "memtable_bytes": self._mem_controller.used,
                "hbm": (
                    self._device_budget.stats()
                    if self._device_budget is not None
                    else None
                ),
            }

    def cache_stats(self) -> dict:
        """Block-cache stats when the store is a CachingStore
        (reference: Engine.CacheStats engine.go:2123+)."""
        if hasattr(self.store, "cache_stats"):
            return self.store.cache_stats()
        return {}

    def debug_info(self) -> dict:
        """Extended introspection (reference: Engine.DebugInfo)."""
        with self._lock:
            info = self.stats()
            info["manifest_versions"] = self.manifests.list_versions()
            info["dirty_pk_ids"] = len(self.pk.dirty_sorted())
            info["cache"] = self.cache_stats()
            for seg in info["segments"]:
                h = next(x for x in self._segments if x.seg_id == seg["seg_id"])
                if hasattr(h.segment, "graph_stats"):
                    seg["graph"] = h.segment.graph_stats()
                seg["stats"] = h.info.stats.get("row_count")
            return info

    def close(self):
        """Checkpoint PK and close (reference: Close engine.go:2226-2258).

        The checkpoint pointer goes into a PKCURRENT sidecar, NOT an in-place
        rewrite of the current MANIFEST: manifest versions stay immutable
        (append-only + CAS story intact; a plain S3 overwrite would be racy).
        """
        if self._closed:
            return
        self.stop_background()
        with self._lock:
            if not self.options.read_only and self.manifests.exists():
                name = f"pk_{self._version:06d}.ckpt"
                # Bound to committed state: a checkpoint must never reference
                # the volatile memtable or post-commit LSNs (crash model =
                # lose everything since last Commit; reopen would otherwise
                # resolve ids to memtable rows that no longer exist).
                self.store.put(
                    name, self.pk.checkpoint_bytes(max_lsn=self._committed_lsn)
                )
                self.store.put(
                    PK_SIDECAR,
                    json.dumps({"version": self._version, "blob": name}).encode(),
                )
            self._closed = True
        self._log.info("close: version=%d", self._version)


class WriteBatch:
    """Atomic multi-op batch: queue inserts/deletes, apply under one lock
    acquisition (reference: engine/batch.go:31, ApplyBatch:70)."""

    def __init__(self, engine: Engine):
        self.engine = engine
        self._inserts = []  # (vector, metadata, payload, text, id)
        self._deletes = []

    def insert(self, vector, metadata=None, payload=None, text=None, id=None):
        self._inserts.append((np.asarray(vector, np.float32), metadata, payload, text, id))
        return self

    def delete(self, id: int):
        self._deletes.append(int(id))
        return self

    def apply(self) -> List[int]:
        """Apply all ops atomically; returns assigned insert ids."""
        eng = self.engine
        eng._check_writable()
        with eng._lock:
            ids = []
            if self._inserts:
                vectors = np.stack([op[0] for op in self._inserts])
                auto = eng.options.auto_flush
                eng.options.auto_flush = False  # no flush mid-batch
                try:
                    ids = eng.insert_batch(
                        vectors,
                        [op[1] for op in self._inserts],
                        [op[2] for op in self._inserts],
                        [op[3] for op in self._inserts]
                        if any(op[3] is not None for op in self._inserts)
                        else None,
                        [op[4] for op in self._inserts]
                        if all(op[4] is not None for op in self._inserts)
                        else None,
                    )
                finally:
                    eng.options.auto_flush = auto
            for id in self._deletes:
                eng.delete(id)
        if (
            eng.options.auto_flush
            and len(eng.memtable) >= eng.options.flush_threshold
        ):
            eng.commit()
        return ids
