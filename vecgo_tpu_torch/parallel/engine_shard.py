"""The engine's data plane over a grid of devices (port of
vecgo_tpu/parallel/engine_shard.py).

- **ShardedSnapshotSearcher**: a snapshot's committed segments as one row
  space, split over the grid (`mesh.ShardedFlat`), tombstones in the shard
  mask; rows map back to ids through the concatenated id column.
- **ShardedEngineSearcher**: the whole serving plane (coded graph
  segments, flat segments, the memtable) with the engine's MVCC merge.
- **sharded_cluster_knn** / **sharded_prune**: the clustered build's
  cluster-KNN stage and its RobustPrune split over the grid
  (`index/build_fast.build_graph_clustered(mesh=...)`).
- **dryrun_engine_sharded**: one small pass of both planes
  (`entry.dryrun_multichip`).

Reduction is single-controller, as in `mesh`: every grid entry's work is
launched on its device, and the results are moved to the grid's first
device and merged there.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from vecgo_tpu_torch.engine.pk import DELETED
from vecgo_tpu_torch.index import build_fast as bf
from vecgo_tpu_torch.model import Metric
from vecgo_tpu_torch.ops import beam as beam_ops
from vecgo_tpu_torch.ops import distance as D
from vecgo_tpu_torch.ops import topk as T
from vecgo_tpu_torch.parallel.mesh import Mesh, ShardedFlat, ShardedIVF, _on, replicate
from vecgo_tpu_torch.utils.tensors import host_tensor

# Lsn of a dirty id with no visible version at the snapshot (no row has it).
_INVISIBLE = -(1 << 62)


class ShardedSnapshotSearcher:
    """Splits a snapshot's committed segments row-wise over a device grid.

    Built once per snapshot and grid (the corpus is uploaded shard by
    shard); queries then run the exact sharded scan. Deletions visible at
    the snapshot are in the shard mask. The memtable is not included:
    callers searching a live engine commit first (the reference's read
    replicas are committed-only too).
    """

    def __init__(self, snapshot, mesh: Mesh, metric: Metric = Metric.L2):
        self.mesh = mesh
        self.metric = metric
        xs, ids, masks = [], [], []
        self.seg_ids = []
        for h in snapshot.segments:
            seg = h.segment
            if seg.n == 0:
                continue
            xs.append(np.asarray(seg.vectors, np.float32))
            ids.append(np.asarray(seg.ids, np.int64))
            dead = snapshot.tombstones.deleted_mask(seg.seg_id, seg.n, snapshot.lsn)
            masks.append(~dead if dead is not None else np.ones(seg.n, bool))
            self.seg_ids.append(seg.seg_id)
        if not xs:
            self.flat = None
            self.ids = np.zeros(0, np.int64)
            return
        self.ids = np.concatenate(ids)
        x = xs[0] if len(xs) == 1 else np.concatenate(xs)
        self.flat = ShardedFlat(x, mesh, metric=metric, mask=np.concatenate(masks))

    def search(self, q, k: int):
        """Exact sharded top-k over the snapshot. Returns host arrays (ids
        [B, k] int64, -1 missing; dists [B, k] f32, +inf there)."""
        b = len(q)
        if self.flat is None:
            return np.full((b, k), -1, np.int64), np.full((b, k), np.inf, np.float32)
        d, rows = self.flat.search(q, k)
        rows, d = rows.cpu().numpy(), d.cpu().numpy()
        out = np.where(rows >= 0, self.ids[np.maximum(rows, 0)], -1)
        return out, np.where(rows >= 0, d, np.inf).astype(np.float32)


class _Source:
    """One segment of the sharded plane: its scan ("ivf" or "flat"), its
    id and lsn columns on the grid's first device, and for a coded
    segment the tensors its refinement and its exact rerank read."""

    def __init__(self, kind, seg, home, dead):
        self.kind = kind
        self.seg = seg
        self.ids = host_tensor(np.asarray(seg.ids, np.int64)).to(home)
        self.lsns = host_tensor(np.asarray(seg.lsns, np.int64)).to(home)
        self.dead = None if dead is None else torch.from_numpy(dead).to(home)
        self.replicas = {}  # device -> (table, graph), the refinement's


class ShardedEngineSearcher:
    """The engine's whole serving plane over a device grid (reference: the
    per-segment fan-out over memtable and segments, engine/search.go:
    790-909).

    - A coded graph segment: its own SQ8-residual table split over the
      grid's clusters (`ShardedIVF`, kernel B); no f32 copy is scanned.
      `refine_steps > 0` walks the coded graph from the shortlist, the
      query axis split over every grid entry, with the table and graph
      on every device (one copy per distinct device).
    - A flat or table-less segment: its rows split over the grid
      (`ShardedFlat`, kernel A), tombstones in the shard mask.
    - The memtable: `MemTable.search` on the grid's first device (kernel
      A, the alive mask).

    Each source's window is ranked by exact IEEE fp32 distances: the scan's
    own for the f32 flat and memtable scans, and for a coded segment a
    rerank against its full-precision rows, which the searcher holds on
    the grid's first device (the JAX searcher gathers them on the host).
    The merge on that device drops tombstoned rows and, for multi-version
    ("dirty") ids, rows that are not the version visible at the snapshot
    (the engine's `_finish` rule), then keeps each id's first occurrence in
    distance order.
    """

    def __init__(self, snapshot, mesh: Mesh, metric: Metric = Metric.L2, pk=None,
                 include_memtable: bool = True):
        self.mesh = mesh
        self.metric = metric.compute()
        self.pk = pk
        self.lsn = snapshot.lsn
        self.home = home = mesh.devices[0, 0]
        self.sources = []
        for h in snapshot.segments:
            seg = h.segment
            if seg.n == 0:
                continue
            dead = snapshot.tombstones.deleted_mask(seg.seg_id, seg.n, snapshot.lsn)
            if getattr(seg, "ivf_members", None) is not None:
                src = _Source("ivf", seg, home, dead)
                state = seg.device_state(home)
                src.table, src.graph = state["ivfq"], state["graph"]
                src.scan = ShardedIVF(src.table, mesh)
                src.full = host_tensor(np.asarray(seg.vectors, np.float32)).to(home)
                src.rnorm2 = host_tensor(np.asarray(seg.rnorm2, np.float32)).to(home)
            else:
                src = _Source("flat", seg, home, None)
                src.scan = ShardedFlat(np.asarray(seg.vectors, np.float32), mesh, metric=metric,
                                       mask=None if dead is None else ~dead)
            self.sources.append(src)
        self.mem = None
        if include_memtable and snapshot.mem_rows:
            mem, n_vis = snapshot.memtable, snapshot.mem_rows
            dead = mem.deleted_mask(n_vis, snapshot.lsn)
            self.mem = (
                mem, n_vis,
                host_tensor(np.asarray(mem.ids[:n_vis], np.int64)).to(home),
                host_tensor(np.asarray(mem.lsns[:n_vis], np.int64)).to(home),
                None if dead is None else torch.from_numpy(~dead).to(home),
            )

    # ---------------- coded graph refinement over every grid entry --------

    def _refine(self, src: _Source, q: torch.Tensor, pool: torch.Tensor, ef: int,
                beam_width: int, steps: int):
        """Walk the coded graph from each query's pool [B, P] (segment rows,
        -1 empty), the query axis split over every grid entry, each with the
        table and graph on its device. Returns (dists, rows) [B, ef] on the
        grid's first device."""
        entries = self.mesh.entries()
        b = q.shape[0]
        pad = (-b) % len(entries)
        if pad:
            q = torch.cat([q, q.new_zeros((pad, q.shape[1]))])
            pool = torch.cat([pool, pool.new_zeros((pad, pool.shape[1]))])
        per = q.shape[0] // len(entries)
        out_d, out_r = [], []
        for e, dev in enumerate(entries):
            if dev not in src.replicas:
                src.replicas[dev] = (type(src.table)(*(None if t is None else t.to(dev)
                                                       for t in src.table)),
                                     src.graph.to(dev))
            table, graph = src.replicas[dev]
            qe = q[e * per:(e + 1) * per].to(dev)
            qc = qe @ table.centroids.T
            d2, r2 = beam_ops.beam_search_coded(qe, table, graph,
                                                pool[e * per:(e + 1) * per].to(dev), qc,
                                                ef=ef, k=ef, beam_width=beam_width,
                                                max_steps=steps)
            out_d.append(d2.to(self.home, non_blocking=True))
            out_r.append(r2.to(self.home, non_blocking=True))
        return torch.cat(out_d)[:b], torch.cat(out_r)[:b]

    # ---------------- search ----------------

    def search(self, q, k: int, n_probe_local: int = 8, kk: int = 16, refine_steps: int = 0,
               ef: int = 64, beam_width: int = 4):
        """Sharded fan-out over every source. Returns host arrays (ids
        [B, k] int64, -1 missing; dists [B, k] f32, +inf there), ranked by
        exact fp32 distance and visible at the snapshot."""
        home = self.home
        qt = torch.from_numpy(np.ascontiguousarray(q, np.float32)).to(home)
        b = qt.shape[0]
        cand_d, cand_id, cand_lsn = [], [], []
        for src in self.sources:
            if src.kind == "ivf":
                _, rows = src.scan.search(qt, n_probe_local=n_probe_local, kk=kk)
                if refine_steps > 0:
                    _, rows = self._refine(src, qt, rows[:, :ef], ef, beam_width, refine_steps)
                if src.dead is not None:
                    rows = torch.where((rows >= 0) & src.dead[rows.clamp_min(0)], -1, rows)
                dd = T.rerank_exact(qt, rows, src.full, src.rnorm2, self.metric)
            else:
                dd, rows = src.scan.search(qt, min(k + 16, src.seg.n))
            safe = rows.clamp_min(0)
            cand_d.append(torch.where(rows >= 0, dd, math.inf))
            cand_id.append(torch.where(rows >= 0, src.ids[safe], -1))
            cand_lsn.append(torch.where(rows >= 0, src.lsns[safe], -1))
        if self.mem is not None:
            mem, n_vis, ids, lsns, alive = self.mem
            qm = D.normalize(qt) if self.metric == Metric.COSINE else qt
            dd, rows = mem.search(qm, min(k + 16, n_vis), n_vis, mask=alive)
            found = torch.isfinite(dd)
            safe = rows.clamp_min(0)
            cand_d.append(dd)
            cand_id.append(torch.where(found, ids[safe], -1))
            cand_lsn.append(torch.where(found, lsns[safe], -1))
        if not cand_d:
            return np.full((b, k), -1, np.int64), np.full((b, k), np.inf, np.float32)
        return self._merge(torch.cat(cand_d, 1), torch.cat(cand_id, 1), torch.cat(cand_lsn, 1), k)

    def _visible_lsns(self, ids: np.ndarray) -> np.ndarray:
        """The lsn of each id's version visible at the snapshot (the PK
        chain), or _INVISIBLE where it is deleted or absent."""
        out = np.full(len(ids), _INVISIBLE, np.int64)
        for n, i in enumerate(ids):
            ent = self.pk.get_entry(int(i), self.lsn)
            if ent is not None and ent[1] != DELETED:
                out[n] = ent[0]
        return out

    def _merge(self, d, ids, lsns, k: int):
        """MVCC merge of the candidates [B, W] (the engine's `_finish`
        rule): sorted by distance (stable), dirty ids kept only at their
        visible version, each id's first occurrence kept, the first k."""
        order = torch.sort(d, dim=1, stable=True).indices
        d, ids, lsns = d.gather(1, order), ids.gather(1, order), lsns.gather(1, order)
        valid = torch.isfinite(d) & (ids >= 0)
        dirty = self.pk.dirty_sorted() if self.pk is not None else np.zeros(0, np.int64)
        if len(dirty):
            flagged = valid & torch.isin(ids, torch.from_numpy(dirty).to(d.device))
            seen = torch.unique(ids[flagged])
            if seen.numel():
                vis = torch.from_numpy(self._visible_lsns(seen.cpu().numpy())).to(d.device)
                pos = torch.searchsorted(seen, ids).clamp_max(seen.numel() - 1)
                valid &= ~flagged | (lsns == vis[pos])
        # Each id's first valid occurrence: a stable sort by id puts its
        # copies side by side in distance order.
        key = torch.where(valid, ids, -1)
        by_id = torch.sort(key, dim=1, stable=True).indices
        sk = key.gather(1, by_id)
        dup_sorted = torch.zeros_like(valid)
        dup_sorted[:, 1:] = (sk[:, 1:] == sk[:, :-1]) & (sk[:, 1:] >= 0)
        keep = valid & ~torch.zeros_like(valid).scatter(1, by_id, dup_sorted)
        sel = torch.sort((~keep).to(torch.int8), dim=1, stable=True).indices[:, :k]
        got = keep.gather(1, sel)
        out_ids = torch.where(got, ids.gather(1, sel), -1).cpu().numpy()
        out_d = torch.where(got, d.gather(1, sel), math.inf).cpu().numpy().astype(np.float32)
        b, w = out_ids.shape
        if w < k:
            out_ids = np.concatenate([out_ids, np.full((b, k - w), -1, np.int64)], 1)
            out_d = np.concatenate([out_d, np.full((b, k - w), np.inf, np.float32)], 1)
        return out_ids, out_d


def sharded_cluster_knn(x16, rnorm2, members, mem_slot, knn: int, overlap: int, n_out: int,
                        g: int, mesh: Mesh):
    """`build_fast._cluster_knn` with the cluster axis split over every grid
    entry: each entry computes the exact KNN of its clusters into a
    per-point table [n_out, overlap, knn] (-1 padded), and the tables merge
    by elementwise max on the first entry's device: each (point, slot) pair
    is written by one cluster, so by one entry, and -1 is max's identity.
    The entries take whole groups of g clusters in order (the JAX package
    pads the axis to g x entries; here the last entries take fewer groups,
    or none), so every group is the product the one-device stage computes.
    x16 / rnorm2: tensors, or their `mesh.replicate` maps; members /
    mem_slot [K, Cmax] numpy or tensors."""
    entries = mesh.entries()
    members, mem_slot = torch.as_tensor(members), torch.as_tensor(mem_slot)
    k_pad = members.shape[0]
    n_groups = -(-k_pad // g)
    per = -(-n_groups // len(entries)) * g  # clusters per entry, whole groups
    x16 = x16 if isinstance(x16, dict) else replicate(x16, mesh)
    rnorm2 = rnorm2 if isinstance(rnorm2, dict) else replicate(rnorm2, mesh)
    cand = None
    for e, dev in enumerate(entries):
        if e * per >= k_pad:
            break
        part = bf._cluster_knn(x16[dev], rnorm2[dev], _on(members[e * per:(e + 1) * per], dev),
                               _on(mem_slot[e * per:(e + 1) * per], dev), knn, overlap, n_out,
                               g).to(entries[0], non_blocking=True)
        cand = part if cand is None else torch.maximum(cand, part)
    return cand


def sharded_prune(cand, x16, rnorm2, x_occ, rn_occ, r: int, alpha: float, block: int,
                  rev_cap: int, mesh: Mesh, one_pass: bool = False):
    """RobustPrune of candidate rows [N_pad, L] split over every grid entry,
    each entry pruning its slice with global row ids (`_prune_all`'s
    row0), the corpus on every device. one_pass=True (the build's default:
    `cand` already carries the reverse candidates) prunes once and
    concatenates; otherwise the concatenated graph's reverse edges
    (`_reverse_dev`) join each slice's rows for a second prune. Returns
    [N_pad, r] int64 on the first entry's device."""
    entries = mesh.entries()
    n_dev = len(entries)
    n_pad, width = cand.shape
    lblock = min(block, max(128, n_pad // n_dev))
    step = n_dev * lblock
    n_full = -(-n_pad // step) * step
    if n_full > n_pad:
        cand = torch.cat([cand, cand.new_full((n_full - n_pad, width), -1)])
    per = n_full // n_dev
    reps = [t if isinstance(t, dict) else replicate(t, mesh) for t in (x16, rnorm2, x_occ, rn_occ)]

    def prune(c, e, dev):
        return bf._prune_all(c, *(t[dev] for t in reps), r, alpha, lblock, row0=e * per)

    parts = [prune(_on(cand[e * per:(e + 1) * per], dev), e, dev)
             for e, dev in enumerate(entries)]
    if not one_pass:
        rev = bf._reverse_dev(torch.cat([p.to(entries[0]) for p in parts]), rev_cap)
        parts = [prune(torch.cat([parts[e], _on(rev[e * per:(e + 1) * per], dev)], 1), e, dev)
                 for e, dev in enumerate(entries)]
    return torch.cat([p.to(entries[0], non_blocking=True) for p in parts])[:n_pad]


def dryrun_engine_sharded(mesh: Mesh) -> None:
    """One small pass over the grid: an engine snapshot's sharded search,
    the sharded cluster-KNN stage, the sharded coded table, and the whole
    sharded engine plane (coded scan, graph refinement over the grid,
    memtable, deletes and an update) against the exact visible answer.
    The engines run on the grid's first device."""
    from vecgo_tpu_torch.blobstore import MemoryStore
    from vecgo_tpu_torch.engine import Engine, EngineOptions
    from vecgo_tpu_torch.entry import _gaussian
    from vecgo_tpu_torch.ops import ivf as ivf_ops

    home = mesh.devices[0, 0]
    d = 16
    n = 64 * mesh.size
    eng = Engine.open(MemoryStore(), EngineOptions(dim=d, flush_threshold=10**9,
                                                   graph_threshold=10**9, device=home),
                      create=True)
    x = _gaussian(n, d, 50)
    ids = eng.insert_batch(x)
    eng.commit()
    eng.delete(ids[1])
    snap = eng.snapshot()
    try:
        got, dist = ShardedSnapshotSearcher(snap, mesh, eng.options.metric).search(x[:8], k=3)
    finally:
        snap.release()
    assert got.shape == (8, 3)
    assert int(got[0, 0]) == ids[0] and float(dist[0, 0]) < 1e-5
    assert all(int(i) != ids[1] for i in got[1])  # the tombstone holds
    eng.close()

    # The build's cluster-KNN stage over the grid.
    x16 = torch.from_numpy(x).to(home, torch.bfloat16)
    rn = torch.from_numpy(np.einsum("nd,nd->n", x, x, dtype=np.float64).astype(np.float32)).to(home)
    members = np.arange(n, dtype=np.int32).reshape(4, n // 4)
    slots = np.zeros((4, n // 4), np.int32)
    cand = sharded_cluster_knn(x16, rn, members, slots, 8, 1, n, 1, mesh).cpu().numpy()
    assert cand.shape == (n, 1, 8) and (cand.reshape(n, -1) >= 0).any(axis=1).all()

    # The coded table split over the grid. The toy membership is sliced by
    # index, not by geometry: every cluster is probed, so the exact self
    # match is in the pool.
    table = ivf_ops.device_table_coded(members, torch.from_numpy(x).to(home))
    dd, rows = ShardedIVF(table, mesh).search(x[:8], n_probe_local=4, kk=4)
    rows = rows.cpu().numpy()
    assert rows.shape[0] == 8 and (rows[:, 0] == np.arange(8)).all(), rows[:, 0]
    # The coded self-distance is bounded by the SQ8 step, far below the ~2d
    # distance between two gaussian rows.
    assert float(dd[0, 0]) < 1.0, float(dd[0, 0])

    # The whole engine plane: a coded graph segment, memtable rows, deletes
    # in both and an update, against the exact answer over visible rows.
    eng2 = Engine.open(MemoryStore(), EngineOptions(
        dim=d, flush_threshold=10**9, graph_threshold=64, compaction_threshold=2,
        serve_ivf_min_n=64, device=home), create=True)
    x2 = _gaussian(6 * 64, d, 51)
    ids2 = eng2.insert_batch(x2[:256])
    eng2.commit()
    eng2.insert_batch(x2[256:320])
    eng2.commit()
    eng2.compact([h.seg_id for h in eng2._segments])  # one coded graph segment
    ids_mem = eng2.insert_batch(x2[320:360])  # memtable rows
    eng2.delete(ids2[3])  # a segment tombstone
    eng2.delete(ids_mem[1])  # a memtable tombstone
    eng2.insert(x2[360], id=ids2[5])  # an update: a dirty id, its old row stale
    assert any(getattr(h.segment, "ivf_members", None) is not None for h in eng2._segments), \
        "the dry run must drive the coded sharded path"
    snap2 = eng2.snapshot()
    try:
        ses = ShardedEngineSearcher(snap2, mesh, eng2.options.metric, eng2.pk)
        got_ids, _ = ses.search(x2[:6], k=5, n_probe_local=8, kk=16, refine_steps=2, ef=32)
    finally:
        snap2.release()
    exp_ids, _ = _brute_visible(eng2, x2[:6], 5)
    assert (got_ids == exp_ids).all(), (got_ids, exp_ids)
    assert int(got_ids[3, 0]) != ids2[3]  # a deleted id never surfaces
    eng2.close()
    print("dryrun_engine_sharded OK: sharded snapshot search + sharded build knn + sharded "
          "coded-IVF serving + the whole sharded engine plane (coded scan + graph refinement "
          "over the grid + memtable + MVCC)")


def _brute_visible(eng, q: np.ndarray, k: int):
    """The exact answer over the engine's visible rows (through scan)."""
    recs = [(c.id, c.vector) for c in eng.scan()]
    ids = np.asarray([r[0] for r in recs], np.int64)
    vv = np.stack([r[1] for r in recs]).astype(np.float32)
    dd = (np.einsum("bd,bd->b", q, q)[:, None] + np.einsum("nd,nd->n", vv, vv)[None, :]
          - 2.0 * q @ vv.T)
    order = np.argsort(dd, axis=1, kind="stable")[:, :k]
    return ids[order], np.take_along_axis(dd, order, axis=1)


__all__ = ["ShardedEngineSearcher", "ShardedSnapshotSearcher", "dryrun_engine_sharded",
           "sharded_cluster_knn", "sharded_prune"]
