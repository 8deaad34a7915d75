"""Vamana (graph) segment of the port (vecgo_tpu/index/vamana.py).

The container format is shared: `VamanaWriter` writes the same sections and
meta as the JAX writer, and either package opens the other's segments. The
host half (row buffer, sections, metadata, docs and payloads) is the JAX
module's; the builds, the device state and the searches are the port's.

Two builds, as in the JAX package: "clustered" (index/build_fast.py, the
default) and "beam" (`build_graph`: two passes of blockwise lockstep beam
search from IVF-guided entries, RobustPrune, then a reverse-edge re-prune;
its serving membership comes from `ops.ivf.build_ivf_table`).

Serving (`search`): a segment of at least `ivf_min_n` rows carries the
build's IVF membership, from which `device_state` encodes the SQ8-residual
coded table plus the int16 refinement plane: the only vector data on the
device (`serve_compact` repacks it to one slot per row first, and doubles
the automatic probes). A query batch takes an IVF shortlist through kernel B
(`ops.ivf.ivf_scan`), optionally one lockstep graph-refine round over the
codes, and an optional rescore of the pool on the int16 plane. Smaller
segments walk the graph from IVF-guided entry nodes over a bf16 copy.

Beyond the device budget a coded segment serves through the cluster cache
(`search_cached`, ops/ivf_cache.py: a fixed number of cluster blocks on the
device, admitted by LRU from the host's coded table or, with persisted codes
(`store_codes`, the `ivfq.*` sections), from ranged reads of the store; a
batch whose probed clusters outnumber the cache's slots is scanned in
chunks of clusters that fit, so no probe is dropped), or
streams its rows (`stream_state`); callers rerank either exactly from the
host's rows (`rerank_host`).
"""

from __future__ import annotations

import math
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from vecgo_tpu_torch.errors import ErrCorrupt
from vecgo_tpu_torch.index import common
from vecgo_tpu_torch.index.flat import segment_stats
from vecgo_tpu_torch.metadata.columnar import ColumnarMeta
from vecgo_tpu_torch.model import Metric
from vecgo_tpu_torch.ops import beam as beam_ops
from vecgo_tpu_torch.ops import distance as D
from vecgo_tpu_torch.ops import ivf as ivf_ops
from vecgo_tpu_torch.ops import topk as T
from vecgo_tpu_torch.storage import container
from vecgo_tpu_torch.utils.tensors import checked_device

SEGMENT_KIND = "vamana"

DEFAULT_R = 32
DEFAULT_L_BUILD = 64
DEFAULT_ALPHA = 1.2

# Slots scored per block of the masked brute-force scan.
_SCAN_BLOCK = 65536


# Coded candidates a probed cluster in the cached search; four times as many
# for a PQ host table (64: still within kernel B's in-shared-memory lists).
CACHED_KK = 16


def cached_scan_params(k: int, ef: int, n_clusters: int, slots: int, pq: bool):
    """(n_probe, kk, pool) of `VamanaSegment.search_cached` for a pool of k
    at list size ef over n_clusters clusters of `slots` slots. The probes and
    the pool follow the JAX package's rule. kk does not: the JAX package takes
    max(8, min(16, ceil(2 ef / n_probe))), which is 8 wherever n_probe
    follows ef, and a query whose neighbours crowd one cluster then loses
    those past the 8th whatever ef or the pool (ROADMAP.md section 3). The
    port scans CACHED_KK, the top of that rule's range."""
    n_probe = int(min(n_clusters, max(16, (ef + 15) // 16 * 4)))
    kk, pool = CACHED_KK, max(ef, k)
    if pq:
        # The PQ transport orders more coarsely than SQ8: a wider scan and
        # dedup cut, which the exact host rerank repairs.
        kk *= 4
        pool = max(pool, 2 * k, 2 * ef)
    return n_probe, min(kk, slots), pool


def coarse_quantize(x: np.ndarray, n_centroids: int, seed: int = 42, device="cuda"):
    """Coarse k-means over the corpus on `device`: (centroids [C, d],
    assign [N], entry_nodes [C], the row nearest each centroid; an empty
    cluster points at the globally nearest row). Beam search starts at the
    entry nodes of the query's nearest centroids (IVF-guided entries)."""
    from vecgo_tpu_torch.quantization import kmeans as km

    centroids, _ = km.train_kmeans(x, n_centroids, seed=seed, device=device)
    assign, dist = km.assign_partitions(x, centroids, device=device)
    entry_nodes = np.zeros(n_centroids, np.int32)
    order = np.lexsort((dist, assign))
    a_s = assign[order]
    first = np.r_[True, a_s[1:] != a_s[:-1]] if len(a_s) else np.zeros(0, bool)
    entry_nodes[a_s[first]] = order[first]
    seen = np.zeros(n_centroids, bool)
    seen[a_s[first]] = True
    if not seen.all():
        entry_nodes[~seen] = int(np.argmin(dist))
    return centroids, assign, entry_nodes


def _cluster_aware_init(n: int, r: int, assign: np.ndarray, rng) -> np.ndarray:
    """Initial graph: half cluster-local random edges, half global random
    (the JAX package's numpy draws)."""
    g = rng.integers(0, n, size=(n, r), dtype=np.int64).astype(np.int32)
    local = r // 2
    order = np.argsort(assign, kind="stable")
    starts = np.searchsorted(assign[order], assign)
    ends = np.searchsorted(assign[order], assign, side="right")
    width = np.maximum(ends - starts, 1)
    offs = rng.integers(0, 1 << 62, size=(n, local)) % width[:, None]
    g[:, :local] = order[starts[:, None] + offs]
    g[g == np.arange(n, dtype=np.int32)[:, None]] = -1
    return g


def _reverse_candidates(g: np.ndarray, cap: int, rng) -> np.ndarray:
    """For each node v, up to `cap` nodes u with an edge u -> v ([N, cap]
    int32, -1 padded), a random sample where more exist."""
    n, r = g.shape
    src = np.repeat(np.arange(n, dtype=np.int64), r)
    dst = g.reshape(-1).astype(np.int64)
    keep = dst >= 0
    src, dst = src[keep], dst[keep]
    perm = rng.permutation(len(src))
    src, dst = src[perm], dst[perm]
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    out = np.full((n, cap), -1, np.int32)
    starts = np.searchsorted(dst, np.arange(n))
    ends = np.searchsorted(dst, np.arange(n) + 1)
    take = np.minimum(ends - starts, cap)
    rows = np.repeat(np.arange(n), take)
    offs = np.arange(len(rows)) - np.repeat(np.cumsum(take) - take, take)
    out[rows, offs] = src[np.repeat(starts, take) + offs]
    return out


def build_graph(x: np.ndarray, r: int = DEFAULT_R, l_build: int = DEFAULT_L_BUILD,
                alpha: float = DEFAULT_ALPHA, block: int = 8192, seed: int = 42,
                beam_width: int = 8, passes: int = 2, n_centroids: int = 0, device="cuda"):
    """The beam build of a Vamana graph over host rows x [N, d] on `device`:
    a cluster-aware random init, then `passes` passes (alpha 1, then alpha)
    of blockwise lockstep beam search from each row's cluster entry and the
    medoid, RobustPrune of the visited list with the current neighbours,
    and a reverse-edge re-prune of every row. Returns (graph [N, r] int32,
    medoid, centroids [C, d], entry_nodes [C])."""
    from vecgo_tpu_torch.index.build_fast import _tiny_graph

    n, d = x.shape
    rng = np.random.default_rng(seed)
    if n == 0:
        return np.zeros((0, r), np.int32), 0, np.zeros((0, d), np.float32), np.zeros(0, np.int32)
    x = np.ascontiguousarray(x, np.float32)
    if n <= r + 1:
        g, medoid = _tiny_graph(x, r)
        return g, medoid, x[medoid : medoid + 1].copy(), np.asarray([medoid], np.int32)
    if n_centroids <= 0:
        n_centroids = int(np.clip(n // 1024, 16, 4096))
    centroids, assign, entry_nodes = coarse_quantize(x, n_centroids, seed, device)
    g_init = _cluster_aware_init(n, r, assign, rng)
    medoid = int(((x - x.mean(0)) ** 2).sum(1).argmin())

    dev = torch.device(device)
    vectors = torch.from_numpy(x).to(dev)
    # bf16 traversal copy for the build's searches; RobustPrune reads f32.
    trav16 = vectors.to(torch.bfloat16)
    rnorm2 = (vectors * vectors).sum(1)
    graph = torch.from_numpy(g_init).to(dev)
    entry_of = torch.from_numpy(entry_nodes[assign].astype(np.int64)).to(dev)
    max_steps = l_build // beam_width + 12
    for a in [1.0] * (passes - 1) + [alpha]:
        for s in range(0, n, block):
            rows = torch.arange(s, min(s + block, n), device=dev)
            q_blk = vectors[rows]
            entries = torch.stack([entry_of[rows], torch.full_like(rows, medoid)], 1)
            _, _, _, cand_ids = beam_ops.beam_search(
                q_blk, trav16, rnorm2, graph, entries, ef=l_build, k=1,
                beam_width=beam_width, max_steps=max_steps, with_visited=True)
            cand_all = torch.cat([cand_ids, graph[rows].long()], 1)
            graph[rows] = beam_ops.robust_prune(rows, q_blk, cand_all, vectors, rnorm2,
                                                r_out=r, alpha=a).to(torch.int32)
        rev = torch.from_numpy(_reverse_candidates(graph.cpu().numpy(), r, rng)).to(dev)
        for s in range(0, n, block):
            rows = torch.arange(s, min(s + block, n), device=dev)
            cand_all = torch.cat([graph[rows], rev[rows]], 1).long()
            graph[rows] = beam_ops.robust_prune(rows, vectors[rows], cand_all, vectors, rnorm2,
                                                r_out=r, alpha=a).to(torch.int32)
    return graph.cpu().numpy(), medoid, centroids, entry_nodes


def _tensor(arr: np.ndarray, device, dtype=None) -> torch.Tensor:
    """A host section on `device` (sections are often read-only views of the
    container; device state is never written, so sharing them is safe)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.to(device=device, dtype=dtype)


class VamanaWriter:
    """Builds an immutable vamana segment on `device` ("cuda" by default,
    as the engine; "cpu" for the plain PyTorch path) (reference:
    diskann.NewWriter:97)."""

    def __init__(
        self,
        dim: int,
        metric: Metric = Metric.L2,
        r: int = DEFAULT_R,
        l_build: int = DEFAULT_L_BUILD,
        alpha: Optional[float] = None,
        quantizer: str = "none",
        qparams: Optional[dict] = None,
        seed: int = 42,
        compress: str = "",
        build_mode: str = "clustered",
        build_params: Optional[dict] = None,
        serve_ivf: bool = True,
        ivf_capacity: int = 512,
        ivf_min_n: int = 4096,  # below this, a graph walk beats the table
        store_codes: bool = False,
        device="cuda",
    ):
        """build_mode: "clustered" (cluster-local KNN + RobustPrune,
        index/build_fast.py) or "beam" (the search-based build,
        `build_graph`). alpha=None resolves per mode as in the JAX writer:
        1.5 for clustered, 1.2 for beam. store_codes: False, or True /
        "sq8" / "pq" / "opq" to persist the coded table."""
        if build_mode not in ("clustered", "beam"):
            raise ValueError(f"unknown build_mode {build_mode!r} (clustered|beam)")
        self.compress = compress
        self.dim = dim
        self.metric = metric
        self.r = r
        self.l_build = l_build
        self.build_mode = build_mode
        self.alpha = alpha if alpha is not None else (
            1.5 if build_mode == "clustered" else DEFAULT_ALPHA
        )
        self.build_params = dict(build_params or {})
        self.serve_ivf = serve_ivf
        self.ivf_capacity = ivf_capacity
        self.ivf_min_n = ivf_min_n
        # Persist the SQ8-residual coded table (`ivfq.*` sections) so remote
        # opens can serve from block-granular ranged reads without ever
        # downloading the vectors (reference: codes ARE the on-disk serving
        # payload, diskann/writer.go + segment.go:503-708). Off by default:
        # local serving re-encodes from vectors at open (cheaper than +1
        # byte/dim/slot on every blob for stores that never go remote).
        self.store_codes = store_codes
        self.quantizer_kind = quantizer
        self.qparams = dict(qparams or {})
        self.seed = seed
        self._rows = common.RowBuffer(dim)
        self._preset = None
        self.device = checked_device(device, "VamanaWriter")

    def add(self, vector, id: int, metadata=None, payload: Optional[bytes] = None,
            lsn: int = 0):
        self._rows.add(vector, id, metadata, payload, lsn)

    def add_batch(self, vectors, ids, metadatas=None, payloads=None, lsns=None):
        self._rows.add_batch(vectors, ids, metadatas, payloads, lsns)

    def set_preset_rows(self, cm, docs_csr, payload_csr) -> None:
        """Compaction slab path (see FlatWriter.set_preset_rows)."""
        self._preset = (cm, docs_csr, payload_csr)

    @property
    def row_count(self) -> int:
        return len(self._rows)

    def finish(self) -> bytes:
        from vecgo_tpu_torch.index.build_fast import build_graph_clustered

        n = len(self._rows)
        x, ids = self._rows.stacked(self.metric)
        want_ivf = self.serve_ivf and n >= self.ivf_min_n
        members = None
        if self.build_mode == "clustered":
            out = build_graph_clustered(
                torch.from_numpy(x).to(self.device).to(torch.bfloat16),
                r=self.r, alpha=self.alpha, seed=self.seed, return_membership=want_ivf,
                **self.build_params,
            )
            graph, medoid, centroids, entry_nodes = out[:4]
            if want_ivf:
                members = out[4]
        else:
            graph, medoid, centroids, entry_nodes = build_graph(
                x, r=self.r, l_build=self.l_build, alpha=self.alpha, seed=self.seed,
                device=self.device, **self.build_params)
            if want_ivf:
                _, members = ivf_ops.build_ivf_table(x, capacity=self.ivf_capacity,
                                                     seed=self.seed, device=self.device)
        if self._preset is not None:
            sections, md_meta, cm = common.preset_row_sections(x, ids, self._rows.lsns,
                                                               self._preset)
        else:
            sections, md_meta, cm = common.row_sections(
                x, ids, self._rows.docs, self._rows.payloads, self._rows.lsns)
        sections["graph"] = graph
        sections["entry.centroids"] = centroids
        sections["entry.nodes"] = entry_nodes
        ivf_meta = None
        if members is not None:
            members = np.ascontiguousarray(members, np.int32)
            sections["ivf.members"] = members
            ivf_meta = {"capacity": int(members.shape[1]), "k": int(members.shape[0]),
                        "coded": True}
            if self.store_codes:
                ivf_meta["codes_stored"] = self._store_codes(sections, members, x)
        meta = {
            "kind": SEGMENT_KIND,
            "dim": self.dim,
            "metric": self.metric.value,
            "count": n,
            "medoid": medoid,
            "r": self.r,
            "l_build": self.l_build,
            "alpha": self.alpha,
            "quantizer": {"kind": self.quantizer_kind, "params": dict(self.qparams)},
            "ivf": ivf_meta,
            "metadata": md_meta,
            "stats": segment_stats(x, cm),
        }
        return container.pack_container(meta, sections, compress=self.compress or None)

    def _store_codes(self, sections: dict, members: np.ndarray, x: np.ndarray) -> str:
        """The persisted coded table (cluster-major: one cluster is one
        contiguous byte range, one ranged read): `ivfq.codes` (d bytes a
        slot) for "sq8" / True, or `ivfq.pq` + `ivfq.cb` (+ `ivfq.rot` for
        OPQ) at d/4 bytes a slot, decoded into the SQ8 cache layout on the
        device at admission; then `ivfq.bn`, `.scale`, `.cent`, `.cnorm2`.
        Returns the kind for the meta's `codes_stored`."""
        from vecgo_tpu_torch.ops.ivf_cache import _encode_host, _encode_host_pq

        kind = self.store_codes if isinstance(self.store_codes, str) else "sq8"
        if kind == "sq8":
            h = _encode_host(members, np.asarray(x, np.float32))
            sections["ivfq.codes"] = h["codes"]
        elif kind in ("pq", "opq"):
            h = _encode_host_pq(members, np.asarray(x, np.float32), kind=kind, seed=self.seed,
                                device=self.device)
            sections["ivfq.pq"] = h["pq"]
            sections["ivfq.cb"] = h["cb"]
            if h["rot"] is not None:
                sections["ivfq.rot"] = h["rot"]
        else:
            raise ValueError(f"store_codes={self.store_codes!r} (True|sq8|pq|opq)")
        sections["ivfq.bn"] = h["bn"]
        sections["ivfq.scale"] = h["scale"]
        sections["ivfq.cent"] = h["cent"]
        sections["ivfq.cnorm2"] = h["cnorm2"]
        return kind


class VamanaSegment(common.RowBlobAccess):
    """Immutable graph segment: host sections plus a lazily built device
    state (see module docstring)."""

    DEFAULT_EF_SEARCH = 64
    # Serving memory/compute knob (engine: EngineOptions.serve_compact):
    # repack the coded table to one slot per row at open — half the HBM of
    # the overlap build membership, ~2x the probes for equal recall.
    serve_compact = False
    # int16 refinement plane for pool rescoring (+2 B/dim/row HBM): the int8
    # x̂ rescore caps recall ~2 points below the ef-pool's content
    # (scripts/probe_coded_recall2.py: 0.977 vs 0.999 exact-rr at 200k);
    # the plane restores the pool bound. EngineOptions.serve_refine.
    serve_refine = True

    def __init__(
        self,
        meta: dict,
        sections: Dict[str, np.ndarray],
        seg_id: int = 0,
        lazy=None,  # storage.container.LazyContainer for deferred docs/payload
    ):
        if meta.get("kind") != SEGMENT_KIND:
            raise ErrCorrupt(f"not a vamana segment: kind={meta.get('kind')!r}")
        self.meta = meta
        self.seg_id = seg_id
        self.dim = int(meta["dim"])
        self.metric = Metric(meta["metric"])
        self.n = int(meta["count"])
        self.medoid = int(meta["medoid"])
        self.r = int(meta["r"])
        self.ids: np.ndarray = sections["ids"]
        # Deferred on cloud opens of codes-stored segments (the `vectors`
        # property materializes with one ranged read on first touch; the
        # serving paths below never touch it).
        self._vectors_arr: Optional[np.ndarray] = sections.get("vectors")
        self.rnorm2: np.ndarray = sections["rnorm2"]
        self.lsns: np.ndarray = sections.get("lsns", np.zeros(self.n, np.int64))
        self.graph: np.ndarray = sections["graph"]
        # IVF-guided entries (older segments without them fall back to medoid).
        self.entry_centroids: Optional[np.ndarray] = sections.get("entry.centroids")
        self.entry_nodes: Optional[np.ndarray] = sections.get("entry.nodes")
        # Blocked IVF serving table (two-stage shortlist; ops/ivf.py).
        self.ivf_members: Optional[np.ndarray] = sections.get("ivf.members")
        self.ivf_centroids: Optional[np.ndarray] = sections.get("ivf.centroids")
        self.cm = ColumnarMeta.from_sections(meta["metadata"], sections)
        # The persisted coded table (writer store_codes), when the open holds
        # its sections (local opens; lazy opens leave them in the store and
        # read cluster blocks on demand).
        self._ivfq = None
        if "ivfq.codes" in sections or "ivfq.pq" in sections:
            self._ivfq = {name: sections[f"ivfq.{name}"]
                          for name in ("bn", "scale", "cent", "cnorm2")}
            if "ivfq.pq" in sections:
                self._ivfq.update(pq=sections["ivfq.pq"], cb=sections["ivfq.cb"],
                                  rot=sections.get("ivfq.rot"))
            else:
                self._ivfq["codes"] = sections["ivfq.codes"]
        self._attach_row_blobs(sections, lazy)
        self._dev = None
        self._compact_s = None  # S' of the one-slot-per-row table once built
        self._stream: dict = {}
        self._ccache = None
        self._probe_host = None  # (cent, cnorm2, pq) the cache probes with

    @property
    def vectors(self) -> np.ndarray:
        """Full-precision rows. On a cloud open of a codes-stored segment this
        is DEFERRED — first touch pulls the whole section with one ranged read
        (resident serving, compaction, iteration); the beyond-HBM serving
        paths (cluster_cache / rerank_host) never touch it."""
        if self._vectors_arr is None:
            self._vectors_arr = self._lazy.load("vectors")
        return self._vectors_arr

    @property
    def rows_loaded(self) -> bool:
        """The full-precision rows are in host memory (not deferred)."""
        return self._vectors_arr is not None

    # ---------------- IO ----------------

    @staticmethod
    def open(data: bytes, seg_id: int = 0, verify_checksum: bool = True) -> "VamanaSegment":
        meta, sections = container.unpack_container(data, verify_checksum, copy=False)
        return VamanaSegment._checked(meta, sections, seg_id, None)

    @staticmethod
    def open_lazy(store, name: str, seg_id: int = 0,
                  verify_checksum: bool = True) -> "VamanaSegment":
        """Ranged-read open: hot sections now, docs and payloads deferred.
        A codes-stored segment also defers its vectors: the cluster cache
        reads coded blocks from the store and the exact rerank gathers
        candidate rows by ranged reads, so serving never loads them."""
        lc = container.LazyContainer(store, name, verify_checksum)
        exclude = ("docs.", "payload.", "ivfq.")
        if (lc.meta.get("ivf") or {}).get("codes_stored"):
            exclude += ("vectors",)
        sections = lc.load_many(exclude_prefixes=exclude)
        return VamanaSegment._checked(lc.meta, sections, seg_id, lc)

    @staticmethod
    def _checked(meta, sections, seg_id, lazy) -> "VamanaSegment":
        try:
            return VamanaSegment(meta, sections, seg_id, lazy=lazy)
        except ErrCorrupt:
            raise
        except Exception as e:
            raise ErrCorrupt(f"vamana segment open failed: {e}")

    # ---------------- device ----------------

    def device_state(self, device) -> dict:
        """Coded table (one slot per row with serve_compact; + int16 plane
        with serve_refine) and graph on `device`; segments without a
        membership keep a bf16 traversal copy, norms and the f32 table for
        the graph walk and its exact rerank."""
        device = torch.device(device)
        if self._dev is not None and self._dev["graph"].device == device:
            return self._dev
        graph = _tensor(self.graph, device, torch.int32)
        entry = torch.tensor([self.medoid], dtype=torch.int64, device=device)
        if self.ivf_members is not None:
            xf = _tensor(self.vectors, device, torch.float32)
            src = xf if self.serve_refine else xf.to(torch.bfloat16)
            table = ivf_ops.device_table_coded(self.ivf_members, src, compact=self.serve_compact,
                                               refine=xf if self.serve_refine else None)
            del xf, src
            if self.serve_compact:
                self._compact_s = int(table.rows.shape[1])
            self._dev = {"graph": graph, "entry": entry, "ivfq": table}
            return self._dev
        full = _tensor(self.vectors, device, torch.float32)
        self._dev = {
            "trav": full.to(torch.bfloat16),
            "rnorm2": _tensor(self.rnorm2, device, torch.float32),
            "graph": graph,
            "full": full,
            "entry": entry,
        }
        if self.entry_centroids is not None and len(self.entry_centroids):
            self._dev["entry_centroids"] = _tensor(self.entry_centroids, device, torch.float32)
            self._dev["entry_nodes"] = _tensor(self.entry_nodes, device, torch.int64)
        return self._dev

    def release_device(self):
        self._dev = None

    # ---------------- search ----------------

    def search(self, q, k: int, mask=None, ef: int = 0, beam_width: int = 4,
               n_probe: int = 0, refine_steps: int = 1, rescore: Optional[bool] = None,
               qcap_factor: float = 0.0):
        """Top-k rows. q [B, d] f32 on the device (normalized upstream for
        cosine); mask [N] bool (host or device) filters results. Returns
        (dists [B, k], rows [B, k] int64): distances to the decoded rows
        for coded segments (callers rerank), bf16-scored for table-less
        ones. The knobs are the JAX segment's."""
        b = q.shape[0]
        if self.n == 0:
            return (torch.full((b, k), math.inf, device=q.device),
                    torch.full((b, k), -1, dtype=torch.int64, device=q.device))
        ef = max(ef or max(self.DEFAULT_EF_SEARCH, k), k)
        dev = self.device_state(q.device)
        dmask = None if mask is None else torch.as_tensor(mask, dtype=torch.bool).to(q.device)

        if "ivfq" in dev:
            table = dev["ivfq"]
            kt, s = table.bnorm2.shape
            if n_probe <= 0:
                n_probe = int(min(kt, max(8, min(32, (ef + 15) // 16 * 4))))
                if self.serve_compact:
                    # One slot per row loses the boundary secondaries.
                    n_probe = int(min(kt, 2 * n_probe))
            kk = min(max(8, min(16, -(-2 * ef // max(n_probe, 1)))), s)
            mflat = None if dmask is None else ivf_ops.slot_mask_from_rows(table, dmask)
            qcap = 0
            if qcap_factor > 0:
                qcap = min(max(32, (int(qcap_factor * b * n_probe / max(kt, 1)) + 31) // 32 * 32),
                           b)
            sd, srows = ivf_ops.ivf_scan(q, table, n_probe=n_probe, kk=kk, mask_flat=mflat,
                                         qcap=qcap)
            cd, crows = beam_ops._dedup_topk(sd, srows, ef)
            pool = torch.where(torch.isfinite(cd), crows, -1)
            if refine_steps > 0:
                qc = q.float() @ table.centroids.T
                _, pool = beam_ops.beam_search_coded(
                    q, table, dev["graph"], pool, qc, ef=ef, k=ef, beam_width=beam_width,
                    max_steps=refine_steps, mask=dmask,
                )
            if rescore is None:
                rescore = True
            if not rescore and refine_steps == 0:
                res_d = cd[:, :k]
                return res_d, torch.where(torch.isfinite(res_d), crows[:, :k], -1)
            rd = self.rerank(q, pool)
            o = torch.sort(rd, dim=1, stable=True).indices[:, :k]
            res_d = rd.gather(1, o)
            return res_d, torch.where(torch.isfinite(res_d), pool.gather(1, o), -1)

        entry = dev["entry"]
        max_steps = 0
        if "entry_centroids" in dev:
            # IVF-guided entries: each query starts at the entry nodes of its
            # nearest centroids plus the medoid.
            n_probe = min(4, dev["entry_centroids"].shape[0])
            cd = D.squared_l2(q, dev["entry_centroids"], compute_dtype=torch.bfloat16)
            _, probes = T.topk_smallest(cd, n_probe)
            entry = torch.cat([dev["entry_nodes"][probes], entry[None, :].expand(b, 1)], 1)
            max_steps = ef // max(beam_width, 1) + 12
        return beam_ops.beam_search(q, dev["trav"], dev["rnorm2"], dev["graph"], entry, ef=ef,
                                    k=k, beam_width=beam_width, max_steps=max_steps, mask=dmask)

    def masked_scan(self, q, k: int, mask=None):
        """Brute force over the coded slot space (the planner's low-
        selectivity strategy for coded graph segments): every live slot's
        SQ8 code is scored blockwise and the top 2k slots are kept exactly,
        then mapped to rows and deduplicated (overlap memberships hold a row
        twice). Returns (dists [B, k] vs the decoded rows, rows [B, k])."""
        dev = self.device_state(q.device)
        table = dev["ivfq"]
        k_pad, s, d = table.codes.shape
        n_slots = k_pad * s
        codes = table.codes.reshape(n_slots, d)
        rows_flat = table.rows.reshape(-1).long()
        if mask is None:
            ok = torch.isfinite(table.xnorm2)
        else:
            ok = ivf_ops.slot_mask_from_rows(
                table, torch.as_tensor(mask, dtype=torch.bool).to(q.device))
        qf = q.float()
        q16 = qf.to(torch.bfloat16).float()
        qn = (qf * qf).sum(-1)[:, None, None]
        qc = qf @ table.centroids.T  # [B, K]
        kw = min(2 * k, n_slots)
        b = q.shape[0]
        best_d = torch.full((b, kw), math.inf, device=q.device)
        best_s = torch.full((b, kw), -1, dtype=torch.int64, device=q.device)
        g = max(1, _SCAN_BLOCK // s)  # whole clusters per block: per-cluster terms broadcast
        for c0 in range(0, k_pad, g):
            c1 = min(k_pad, c0 + g)
            prod = (q16 @ codes[c0 * s : c1 * s].float().T).view(b, c1 - c0, s)
            sc = qn + table.xnorm2[None, c0:c1] - 2.0 * (
                qc[:, c0:c1, None] + table.scale[None, c0:c1, None] * prod)
            sc = torch.where(ok[None, c0:c1], sc, math.inf).view(b, -1)
            bd, bi = torch.topk(sc, min(kw, sc.shape[1]), dim=1, largest=False)
            best_d, best_s = T.merge_topk_sorted(best_d, best_s, bd, bi + c0 * s, kw)
        rows = torch.where(torch.isfinite(best_d) & (best_s >= 0),
                           rows_flat[best_s.clamp_min(0)], -1)
        dd, rows = beam_ops._dedup_topk(torch.where(rows >= 0, best_d, math.inf), rows, k)
        dd = torch.where(dd >= beam_ops._BIG, math.inf, dd)
        return dd, torch.where(torch.isfinite(dd), rows, -1)

    def rerank(self, q, rows):
        """Distances of candidate rows [B, C] (-1 -> +inf): to the rows
        decoded from the int16 plane (serve_refine), from the int8 codes,
        or, for table-less segments, to the f32 rows; all in IEEE f32."""
        dev = self.device_state(q.device)
        metric = self.metric.compute()
        safe = rows.long().clamp_min(0)
        qf = q.float()
        if metric == Metric.COSINE:
            qf = D.normalize(qf)
        if "ivfq" in dev:
            t = dev["ivfq"]
            s = t.rows.shape[1]
            slot = t.slot_of_row[safe].long()
            cl = slot // s
            if t.rcodes is not None:
                xhat = t.centroids[cl] + t.rcodes[safe].float() * (
                    t.scale[cl] * ivf_ops.RSCALE_RATIO)[:, :, None]
                xn = (xhat * xhat).sum(-1)
            else:
                codes = t.codes.reshape(-1, t.codes.shape[2])
                xhat = t.centroids[cl] + codes[slot].float() * t.scale[cl][:, :, None]
                xn = t.xnorm2.reshape(-1)[slot]
        else:
            xhat = dev["full"][safe]
            xn = dev["rnorm2"][safe]
        prod = torch.bmm(xhat, qf[:, :, None])[:, :, 0]
        if metric == Metric.L2:
            dd = ((qf * qf).sum(-1, keepdim=True) + xn - 2.0 * prod).clamp_min(0.0)
        elif metric == Metric.DOT:
            dd = -prod
        else:
            dd = 1.0 - prod
        return torch.where(rows >= 0, dd, math.inf)

    # ---------------- beyond the device budget ----------------

    def device_bytes(self) -> int:
        """Device footprint of device_state() (for DeviceBudget admission).
        Under serve_compact the table's S' is known once it has been built;
        until then the overlap table's S bounds it from above."""
        n, d = self.n, self.dim
        if self.ivf_members is not None:
            k, s = self.ivf_members.shape
            k = -(-k // 8) * 8  # the table pads to whole groups of 8 clusters
            if self.serve_compact and self._compact_s is not None:
                s = self._compact_s
            # codes + three [K, S] planes (norms, rows) + slot map + centroids,
            # scale and centroid norms + graph (+ the int16 refinement plane)
            total = k * s * (d + 12) + n * 4 + k * (d * 4 + 8) + self.graph.size * 4
            if self.serve_refine:
                total += n * d * 2
            return int(total)
        total = n * d * 2 + n * 4 + self.graph.size * 4 + n * d * 4
        if self.entry_centroids is not None:
            total += self.entry_centroids.nbytes + self.entry_nodes.size * 8
        return int(total)

    def rerank_host(self, q, rows):
        """Exact rerank gathering candidate rows from host memory (the
        segment has no device residency). With deferred vectors (a lazy
        open), the candidate rows come from coalesced ranged reads:
        O(candidates) store bytes, never the whole section."""
        if self._vectors_arr is None and self._lazy is not None:
            if self._lazy.entries.get("vectors", {}).get("compression"):
                # compressed: not offset-sliceable; one full read
                return common.rerank_host_rows(q, rows, self.vectors, self.rnorm2, self.metric)
            rows_np = rows.cpu().numpy()
            uniq, inv = np.unique(np.maximum(rows_np, 0), return_inverse=True)
            if len(uniq) < max(1, self.n // 2):
                tbl = self._gather_rows_lazy(uniq)
                rows2 = np.where(rows_np >= 0, inv.reshape(rows_np.shape), -1).astype(np.int64)
                return common.rerank_host_rows(
                    q, torch.from_numpy(rows2).to(q.device), tbl, self.rnorm2[uniq], self.metric)
            # Candidate set ~ the corpus: one full read beats row reads.
        return common.rerank_host_rows(q, rows, self.vectors, self.rnorm2, self.metric)

    def _gather_rows_lazy(self, uniq: np.ndarray) -> np.ndarray:
        """[U, d] f32 gather of sorted unique rows via coalesced ranged
        reads of the deferred vectors section."""
        out = np.empty((len(uniq), self.dim), np.float32)
        i = 0
        while i < len(uniq):
            j = i
            while j + 1 < len(uniq) and uniq[j + 1] == uniq[j] + 1:
                j += 1
            blk = self._lazy.load_rows("vectors", int(uniq[i]), int(uniq[j]) + 1)
            out[i : j + 1] = np.asarray(blk, np.float32)
            i = j + 1
        return out

    def stream_state(self, transport: str = "sq8", device="cuda"):
        """(enc_host, scanner): host-resident coded transport for
        beyond-device streaming search. "sq8" uploads 1 byte a dimension
        instead of 4; "pq" uploads d/2 bytes a row and is coarser, so callers
        pool at least 128 and rerank exactly downstream (engine/search.py
        does). Built once per transport; `device` is where the PQ transport
        trains and assigns."""
        if transport not in self._stream:
            mk = common.pq_stream_state if transport == "pq" else common.sq8_stream_state
            self._stream[transport] = mk(self.vectors, self.metric.compute(), device=device)
        return self._stream[transport]

    # ---- beyond the device budget: the cluster cache ----

    CACHE_CLUSTERS = 256

    def cache_bytes(self) -> int:
        """Device footprint of the cluster cache (independent of N), the
        planner's admission charge for the graph_cached source."""
        if self.ivf_members is None:
            return 0
        k, s = self.ivf_members.shape
        c = min(self.CACHE_CLUSTERS, k)
        d = self.dim
        return int(c * (s * (d + 8) + d * 4 + 4) + k * (d * 4 + 8))

    def cluster_cache(self, device="cuda"):
        """The cluster cache on `device`, built at first use
        (ops/ivf_cache.ClusterCachedTable): from the persisted codes when the
        open holds them, from ranged reads of the store when a lazy open left
        them there, else encoded from the vectors on the host."""
        from vecgo_tpu_torch.ops.ivf_cache import (
            ClusterCachedTable, LazyHostTable, MemHostTable, _encode_host)

        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if self._ccache is not None and self._ccache.device == device:
            return self._ccache
        members = self.ivf_members
        if self._ivfq is not None:
            host = MemHostTable(dict(self._ivfq, rows=np.ascontiguousarray(members, np.int32)))
        elif (self._vectors_arr is None and self._lazy is not None
              and (self._lazy.has("ivfq.codes") or self._lazy.has("ivfq.pq"))):
            host = LazyHostTable(self._lazy, members)
        else:
            # The centroids the batch was probed with, when it was.
            cent = self._probe_host[0] if self._probe_host is not None else None
            host = MemHostTable(_encode_host(members, np.asarray(self.vectors, np.float32),
                                             cent=cent))
        self._ccache = ClusterCachedTable(host=host, cache_clusters=self.CACHE_CLUSTERS,
                                          device=device)
        return self._ccache

    def release_cache(self):
        self._ccache = None

    def _probe_table(self):
        """(cent [K, d], cnorm2 [K], pq) on the host: the centroids the cluster
        cache probes with and whether its host table is PQ, without building
        the cache (a built cache's own; the persisted codes' sections; else
        the member means of the rows, `ivf_cache.host_centroids`, the
        encode's own arithmetic)."""
        from vecgo_tpu_torch.ops.ivf_cache import host_centroids

        if self._ccache is not None:
            h = self._ccache.host
            return h.cent, h.cnorm2, h.kind == "pq"
        if self._probe_host is None:
            lazy = self._lazy
            if self._ivfq is not None:
                self._probe_host = (self._ivfq["cent"], self._ivfq["cnorm2"], "pq" in self._ivfq)
            elif (self._vectors_arr is None and lazy is not None
                  and (lazy.has("ivfq.codes") or lazy.has("ivfq.pq"))):
                self._probe_host = (np.asarray(lazy.load("ivfq.cent"), np.float32),
                                    np.asarray(lazy.load("ivfq.cnorm2"), np.float32),
                                    lazy.has("ivfq.pq"))
            else:
                self._probe_host = (*host_centroids(self.ivf_members,
                                                    np.asarray(self.vectors, np.float32)), False)
        return self._probe_host

    def cached_probes(self, q, k: int, ef: int = 0) -> np.ndarray:
        """The probes [B, P] (cluster ids, numpy) that `search_cached` at
        (k, ef) takes for q [B, d] on the device; the cache is not built."""
        from vecgo_tpu_torch.ops.ivf_cache import _probe
        from vecgo_tpu_torch.utils.tensors import host_tensor

        cent, cn, pq = self._probe_table()
        n_clusters, slots = self.ivf_members.shape
        ef = max(ef or max(self.DEFAULT_EF_SEARCH, k), k)
        n_probe = cached_scan_params(k, ef, n_clusters, slots, pq)[0]
        cc = self._ccache
        if cc is not None and cc.device == q.device:
            cent_d, cn_d = cc.cent_dev, cc.cnorm2_dev
        else:
            cent_d, cn_d = (host_tensor(a).to(q.device, torch.float32) for a in (cent, cn))
        return _probe(q.float().contiguous(), cent_d, cn_d,
                      int(min(n_probe, n_clusters))).cpu().numpy()

    def cache_fits(self, probes: np.ndarray) -> bool:
        """Whether the clusters that probes [B, P] want fit the cluster cache
        at once (one chunk in `search_cached`); the cache is not built."""
        from vecgo_tpu_torch.ops.ivf_cache import cache_slots, wanted_clusters

        n_clusters = self.ivf_members.shape[0]
        wanted = wanted_clusters(probes, self._probe_table()[1], n_clusters)
        return len(wanted) <= cache_slots(n_clusters, self.CACHE_CLUSTERS)

    def search_cached(self, q, k: int, mask: Optional[np.ndarray] = None, ef: int = 0,
                      probes: Optional[np.ndarray] = None):
        """The two-stage search's first stage through the cluster cache:
        probe every centroid on the device, scan only the cached cluster
        blocks (misses are admitted on demand). q [B, d] f32 on the device;
        mask [N] bool on the host; probes: `cached_probes(q, k, ef)` when the
        caller has them. A batch whose probed clusters outnumber the cache's
        slots is scanned in chunks of clusters that fit (the resident ones
        first), each (query, probe) pair in the chunk that holds its cluster,
        so no probe is dropped and the answer is that of a cache holding
        every cluster. Returns (dists [B, k] to the decoded rows, rows [B, k]
        int64, -1 missing); callers rerank exactly with rerank_host. No graph
        refinement: the cache holds only the probed clusters, so the default
        probes are wider instead."""
        b = q.shape[0]
        if self.n == 0 or self.ivf_members is None:
            return (torch.full((b, k), math.inf, device=q.device),
                    torch.full((b, k), -1, dtype=torch.int64, device=q.device))
        cc = self.cluster_cache(device=q.device)
        ef = max(ef or max(self.DEFAULT_EF_SEARCH, k), k)
        n_probe, kk, pool = cached_scan_params(k, ef, cc.k, cc.s, cc.host.kind == "pq")
        qd = q.to(cc.device, torch.float32).contiguous()
        if probes is None:
            probes = cc.probe(qd, n_probe)
        chunks = cc.chunks(probes)
        if len(chunks) == 1:
            sd, srows = cc.probe_and_scan(qd, n_probe, kk, row_mask=mask, probes=probes)
        else:
            sd = torch.full((b, probes.shape[1] * kk), math.inf, device=qd.device)
            srows = torch.full(sd.shape, -1, dtype=torch.int64, device=qd.device)
            for chunk in chunks:
                inside = np.isin(probes, chunk)
                sel = np.flatnonzero(inside.any(1))
                sel_t = torch.from_numpy(sel).to(qd.device)
                d_c, r_c = cc.probe_and_scan(qd[sel_t], n_probe, kk, row_mask=mask,
                                             probes=np.where(inside[sel], probes[sel], cc.k))
                keep = torch.from_numpy(np.repeat(inside[sel], kk, axis=1)).to(qd.device)
                sd[sel_t] = torch.where(keep, d_c, sd[sel_t])
                srows[sel_t] = torch.where(keep, r_c, srows[sel_t])
        cd, crows = beam_ops._dedup_topk(sd, srows, pool)
        cd, crows = cd[:, :k], crows[:, :k]
        return cd, torch.where(torch.isfinite(cd), crows, -1)

    # ---- host access (same contract as FlatSegment) ----

    def filter_mask(self, f) -> np.ndarray:
        return self.cm.filter_mask(f)

    # payload() / doc() provided by common.RowBlobAccess (lazy-aware).

    def vector(self, row: int) -> np.ndarray:
        return self.vectors[row]

    def iterate(self):
        for row in range(self.n):
            yield int(self.ids[row]), self.vectors[row], self.doc(row), self.payload(row)

    def graph_stats(self) -> dict:
        """Degree/connectivity stats (reference: hnsw.Stats, stats.go:10)."""
        deg = (self.graph >= 0).sum(1)
        return {
            "nodes": self.n,
            "avg_degree": float(deg.mean()) if self.n else 0.0,
            "min_degree": int(deg.min()) if self.n else 0,
            "max_degree": int(deg.max()) if self.n else 0,
            "medoid": self.medoid,
        }
