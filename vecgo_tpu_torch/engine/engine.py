"""The port's Engine (vecgo_tpu/engine/engine.py on PyTorch).

`Engine` subclasses the JAX package's engine: inserts, deletes, point
lookups, scans, the PK index, manifests, tombstones, vacuum and close are
host code and are inherited as they are. What is overridden here is what
creates or searches device state: open (segments), commit and compact (the
port's writer, segment and memtable classes), the search entry points (the
device planner in `vecgo_tpu_torch.engine.search`), and the paths not
ported yet, which raise `NotImplementedError` naming their ROADMAP.md item.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from typing import Any, List, Optional

import numpy as np
import torch

from vecgo_tpu.blobstore import LocalStore
from vecgo_tpu.engine import engine as jax_engine
from vecgo_tpu.engine.engine import PK_SIDECAR, _id_row_map, _seg_blob
from vecgo_tpu.engine.manifest import ManifestStore, SegmentInfo
from vecgo_tpu.engine.pk import MEMTABLE_SEG, PKIndex
from vecgo_tpu.engine.snapshot import SegmentHandle
from vecgo_tpu.engine.tombstone import SegmentTombstones, TombstoneSet
from vecgo_tpu.errors import ErrClosed, ErrCorrupt, ErrDimensionMismatch, ErrNotFound
from vecgo_tpu.engine.search import _seg_by_id
from vecgo_tpu.model import Candidate, SearchOptions, SearchResult
from vecgo_tpu.index.common import csr_concat, csr_select
from vecgo_tpu.metadata.columnar import ColumnarMeta
from vecgo_tpu.storage import container
from vecgo_tpu_torch._roadmap import not_ported
from vecgo_tpu_torch.engine import search as search_mod
from vecgo_tpu_torch.engine.memtable import MemTable
from vecgo_tpu_torch.index.flat import FlatSegment, FlatWriter
from vecgo_tpu_torch.index.vamana import VamanaSegment, VamanaWriter


@dataclass
class EngineOptions(jax_engine.EngineOptions):
    """The JAX engine's options plus the device that holds segments and
    memtable chunks, runs every scan and builds graphs ("cuda" by default;
    "cpu" runs the kernels' plain PyTorch versions).

    `auto_compact` defaults to False, unlike the JAX engine's True. Below
    `graph_threshold` live rows, compaction writes a flat segment, and from
    2 x `ivf_rows_per_partition` (16,384) rows on that flat segment is
    partitioned (flat IVF), which the port's `FlatWriter` does not write yet
    (ROADMAP.md, port queue item 2): a size-tiered compaction of 16,384 to
    32,767 live rows would raise in ordinary use. An explicit `compact()`
    into a graph segment (at least `graph_threshold` rows) or into a flat
    segment under 16,384 rows works; the default returns to True with
    item 2."""

    auto_compact: bool = False
    device: Any = "cuda"

    def __post_init__(self):
        self.device = torch.device(self.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "EngineOptions(device='cuda') needs a CUDA device; none is "
                "available (pass device='cpu' to run the plain PyTorch path)"
            )
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")


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


class Engine(jax_engine.Engine):
    """The LSM engine on PyTorch (see module docstring)."""

    def __init__(self, store, options: EngineOptions):
        if not isinstance(options, EngineOptions):
            raise TypeError("vecgo_tpu_torch.Engine needs vecgo_tpu_torch EngineOptions")
        if options.lexical:
            raise not_ported("lexical (BM25) indexing", 4)
        super().__init__(store, options)
        self.memtable = MemTable(options.dim, options.metric)

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
        eng._log.info("open: version=%d segments=%d lsn=%d", eng._version,
                      len(eng._segments), eng._lsn)
        return eng

    # ==================== search ====================

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
                        src = snap.memtable if seg_id == -1 else _seg_by_id(snap, seg_id)
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

    def hybrid_search(self, *args, **kw):
        raise not_ported("hybrid (BM25 + vector) search", 4)

    def hybrid_search_batch(self, *args, **kw):
        raise not_ported("hybrid (BM25 + vector) search", 4)

    def enable_device_lexical(self, *args, **kw):
        raise not_ported("device BM25", 4)

    def sharded_searcher(self, mesh):
        raise not_ported("sharded_searcher", 5)

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
                    seed=opt.seed, compress=opt.compress_segments,
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
                seed=opt.seed, compress=opt.compress_segments,
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
