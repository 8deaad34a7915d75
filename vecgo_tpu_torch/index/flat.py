"""Flat (brute-force) segment of the port (vecgo_tpu/index/flat.py).

The container format is shared: `FlatWriter` writes the same bytes as the
JAX writer, and either package opens the other's segments. Host code
(segment stats, the categorical blooms the planner prunes by, row access) is
the JAX module's; the device state and the scans are the port's: quantized
scans go block by block through `ops/topk.BlockScanner` (the fused
`scan_topk` kernel where the quantizer's score has its form, a plain score
matrix otherwise), flat IVF probing through `ops/topk.probed_topk`.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from vecgo_tpu_torch import quantization as Q
from vecgo_tpu_torch.errors import ErrCorrupt
from vecgo_tpu_torch.index import common
from vecgo_tpu_torch.metadata.columnar import ColumnarMeta
from vecgo_tpu_torch.model import Metric
from vecgo_tpu_torch.storage import container
from vecgo_tpu_torch.ops import distance as D
from vecgo_tpu_torch.ops import topk as T


SEGMENT_KIND = "flat"

# Candidates past k that an unquantized scan keeps for its exact f32 rerank:
# over the bf16 copy, over the f32 table (tie-heavy data), and over the bf16
# rows of a gathered copy (a short scan, so a wider pool costs little).
POOL_MARGIN_BF16 = 8
POOL_MARGIN_F32 = 16
POOL_MARGIN_GATHERED = 24


class FlatWriter:
    """Buffered writer: add rows, then finish() -> container bytes.

    `device` is where the IVF k-means and assignment, and a PQ/OPQ
    quantizer's training, run (the card by default); an unquantized,
    unpartitioned segment never touches it."""

    def __init__(
        self,
        dim: int,
        metric: Metric = Metric.L2,
        quantizer: str = "none",
        qparams: Optional[dict] = None,
        ivf_partitions: int = 0,
        train_sample: int = 65536,
        seed: int = 42,
        compress: str = "",
        device="cuda",
    ):
        self.compress = compress
        self.dim = dim
        self.metric = metric
        self.quantizer_kind = quantizer
        self.qparams = dict(qparams or {})
        self.ivf_partitions = ivf_partitions
        self.train_sample = train_sample
        self.seed = seed
        self.device = device
        self._rows = common.RowBuffer(dim)
        self._preset = None

    def add(self, vector, id: int, metadata=None, payload: Optional[bytes] = None,
            lsn: int = 0):
        self._rows.add(vector, id, metadata, payload, lsn)

    def add_batch(self, vectors, ids, metadatas=None, payloads=None, lsns=None):
        self._rows.add_batch(vectors, ids, metadatas, payloads, lsns)

    def set_preset_rows(self, cm, docs_csr, payload_csr) -> None:
        """Rows' metadata, docs and payloads arrive pre-merged, in add order."""
        self._preset = (cm, docs_csr, payload_csr)

    @property
    def row_count(self) -> int:
        return len(self._rows)

    def finish(self) -> bytes:
        """Build the immutable segment; returns container bytes."""
        n = len(self._rows)

        # --- IVF partitioning: reorder rows by nearest centroid ---
        ivf_centroids = None
        ivf_part = None
        order = None
        if self.ivf_partitions > 1 and n > self.ivf_partitions:
            from vecgo_tpu_torch.quantization import kmeans as km

            x, _ = self._rows.stacked(self.metric)
            ivf_centroids, _ = km.train_kmeans(
                x, self.ivf_partitions, seed=self.seed, sample=self.train_sample,
                device=self.device,
            )
            # bf16 transfer: nearest-centroid partitioning tolerates fuzz at
            # the boundaries (queries probe several partitions).
            assign, _ = km.assign_partitions(
                x, ivf_centroids, transfer_dtype=torch.bfloat16, device=self.device
            )
            order = np.argsort(assign, kind="stable")
            self._rows.reorder(order)
            ivf_part = assign[order].astype(np.int32)

        x, ids = self._rows.stacked(self.metric)
        if self._preset is not None:
            sections, md_meta, cm = common.preset_row_sections(
                x, ids, self._rows.lsns, self._preset, order=order
            )
        else:
            sections, md_meta, cm = common.row_sections(
                x, ids, self._rows.docs, self._rows.payloads, self._rows.lsns
            )

        # --- quantization (full-precision vectors always kept for rerank) ---
        quant = Q.create(self.quantizer_kind, device=self.device, dim=self.dim, **self.qparams)
        r = np.random.default_rng(self.seed)
        sample = x
        if n > self.train_sample:
            sample = x[r.choice(n, self.train_sample, replace=False)]
        quant.train(sample, seed=self.seed)
        if self.quantizer_kind != "none":
            for name, arr in quant.encode(x).items():
                sections[f"enc.{name}"] = arr
            for name, arr in quant.state()["arrays"].items():
                if arr is not None:
                    sections[f"q.{name}"] = arr
        if ivf_centroids is not None:
            sections["ivf.centroids"] = ivf_centroids
            sections["ivf.part"] = ivf_part

        meta = {
            "kind": SEGMENT_KIND,
            "dim": self.dim,
            "metric": self.metric.value,
            "count": n,
            "quantizer": {"kind": quant.kind, "params": quant.params()},
            "ivf": {
                "partitions": int(self.ivf_partitions) if ivf_centroids is not None else 0
            },
            "metadata": md_meta,
            "stats": segment_stats(x, cm),
        }
        return container.pack_container(meta, sections, compress=self.compress or None)


def segment_stats(x: np.ndarray, cm: ColumnarMeta) -> dict:
    """Pruning stats stored in the manifest (reference: manifest/stats.go:79-122:
    vector centroid+radius, numeric min/max/mean/histogram, categorical tops)."""
    stats: Dict[str, Any] = {"row_count": int(x.shape[0])}
    if x.shape[0]:
        centroid = x.mean(0, dtype=np.float64).astype(np.float32)
        # ||x_i - c||^2 = ||x_i||^2 - 2 x_i.c + ||c||^2 via one matvec pass —
        # the naive (x - c) form allocates two full-table temps (measured
        # 128 s at 1M x 128 on the degraded-paging dev host vs <1 s here).
        rn = np.einsum("nd,nd->n", x, x, dtype=np.float64)
        xc = (x @ centroid).astype(np.float64)  # f32 sgemv, no full-table temp
        d2 = rn - 2.0 * xc + float(centroid.astype(np.float64) @ centroid)
        stats["centroid"] = [round(float(v), 6) for v in centroid]
        stats["radius"] = float(np.sqrt(max(float(d2.max()), 0.0)))
    fields = {}
    for f, col in cm.numeric.items():
        vals = col[~np.isnan(col)]
        if len(vals):
            hist, edges = np.histogram(vals, bins=16)
            fields[f] = {
                "kind": "num",
                "min": float(vals.min()),
                "max": float(vals.max()),
                "mean": float(vals.mean()),
                "hist": hist.astype(int).tolist(),
                "edges": [float(e) for e in edges],
                "present": int(len(vals)),
            }
    for f, codes in cm.str_codes.items():
        present = codes >= 0
        if present.any():
            counts = np.bincount(codes[present], minlength=len(cm.str_values[f]))
            top = np.argsort(counts)[::-1][:16]
            fields[f] = {
                "kind": "str",
                "values": sorted(cm.str_values[f]) if len(cm.str_values[f]) <= 64 else None,
                "top": [[cm.str_values[f][i], int(counts[i])] for i in top if counts[i] > 0],
                "present": int(present.sum()),
                "bloom": _bloom(cm.str_values[f]),
            }
    # Bool and array fields: presence + value bloom (arrays). Without these
    # entries can_prune_segment would treat the field as absent-everywhere and
    # wrongly prune the whole segment for EQ/CONTAINS filters on it.
    for f, col in cm.bools.items():
        present = col >= 0
        if present.any():
            fields[f] = {
                "kind": "bool",
                "true": int((col == 1).sum()),
                "false": int((col == 0).sum()),
                "present": int(present.sum()),
            }
    for f, indptr in cm.arr_indptr.items():
        nnz = int(indptr[-1]) if len(indptr) else 0
        if nnz:
            vals = [str(v) for v in cm.arr_values[f]]
            fields[f] = {
                "kind": "arr",
                "present": int((np.diff(indptr) > 0).sum()),
                "bloom": _bloom(vals),
            }
    stats["fields"] = fields
    return stats


def _bloom(values: List[str], bits: int = 256, hashes: int = 3) -> str:
    """Tiny hex bloom filter over categorical values (reference: manifest/bloom.go)."""
    import hashlib

    bf = np.zeros(bits, bool)
    for v in values:
        h = hashlib.md5(str(v).encode()).digest()
        for i in range(hashes):
            idx = int.from_bytes(h[i * 4 : i * 4 + 4], "little") % bits
            bf[idx] = True
    return np.packbits(bf).tobytes().hex()


def bloom_may_contain(bloom_hex: str, value: str, bits: int = 256, hashes: int = 3) -> bool:
    import hashlib

    bf = np.unpackbits(np.frombuffer(bytes.fromhex(bloom_hex), np.uint8))
    h = hashlib.md5(str(value).encode()).digest()
    for i in range(hashes):
        idx = int.from_bytes(h[i * 4 : i * 4 + 4], "little") % bits
        if not bf[idx]:
            return False
    return True


class FlatSegment(common.RowBlobAccess):
    """Immutable flat segment: host arrays plus a lazily built device state.

    An unquantized segment keeps its f32 table, norms and a bf16 scan copy on
    the device. A quantized segment keeps **only its codes** (and their
    norms and per-row factors) there: that is the point of quantizing. Its
    scans decode one block at a time to a transient bf16 table, and its exact
    rerank gathers the full-precision rows from host memory.

    Flat IVF: the writer sorts rows by partition, so a partition is one row
    range. With 0 < nprobes < partitions, a search inverts the probes and
    scans each probed partition's range for the queries that probe it
    (`ops/topk.probed_topk`), in place of the JAX scorer's [B, block]
    partition mask; the rows of unprobed partitions are excluded either way.
    """

    def __init__(self, meta: dict, sections: Dict[str, np.ndarray], seg_id: int = 0,
                 lazy=None):
        if meta.get("kind") != SEGMENT_KIND:
            raise ErrCorrupt(f"not a flat segment: kind={meta.get('kind')!r}")
        self.meta = meta
        self.seg_id = seg_id
        self.dim = int(meta["dim"])
        self.metric = Metric(meta["metric"])
        self.n = int(meta["count"])
        self.ids: np.ndarray = sections["ids"]
        self.vectors: np.ndarray = sections["vectors"]
        self.rnorm2: np.ndarray = sections["rnorm2"]
        self.lsns: np.ndarray = sections.get("lsns", np.zeros(self.n, np.int64))
        qmeta = meta["quantizer"]
        qarrays = {name[2:]: arr for name, arr in sections.items() if name.startswith("q.")}
        self.quant = Q.Quantizer.from_state(
            {"kind": qmeta["kind"], "params": qmeta["params"], "arrays": qarrays}
        )
        self.enc_host = {
            name[4:]: arr for name, arr in sections.items() if name.startswith("enc.")
        }
        if qmeta["kind"] == "none":
            self.enc_host = {"vectors": self.vectors, "rnorm2": self.rnorm2}
        self.ivf_centroids = sections.get("ivf.centroids")
        self.ivf_part = sections.get("ivf.part")
        self._part_bounds = None
        if self.ivf_part is not None:
            parts = int(meta["ivf"]["partitions"])
            self._part_bounds = np.searchsorted(np.asarray(self.ivf_part), np.arange(parts + 1))
        self.cm = ColumnarMeta.from_sections(meta["metadata"], sections)
        self._attach_row_blobs(sections, lazy)
        self._dev: Optional[dict] = None
        self._cent_dev = None
        self._streams: dict = {}

    # ---------------- IO ----------------

    @staticmethod
    def open(data: bytes, seg_id: int = 0, verify_checksum: bool = True) -> "FlatSegment":
        meta, sections = container.unpack_container(data, verify_checksum, copy=False)
        return FlatSegment._checked(meta, sections, seg_id, None)

    @staticmethod
    def open_lazy(store, name: str, seg_id: int = 0, verify_checksum: bool = True) -> "FlatSegment":
        """Remote open: header and hot sections through ranged reads; docs
        and payloads stay in the store until first touched."""
        lc = container.LazyContainer(store, name, verify_checksum)
        sections = lc.load_many(exclude_prefixes=("docs.", "payload."))
        return FlatSegment._checked(lc.meta, sections, seg_id, lc)

    @staticmethod
    def _checked(meta, sections, seg_id, lazy) -> "FlatSegment":
        try:
            return FlatSegment(meta, sections, seg_id, lazy)
        except (ErrCorrupt, NotImplementedError):
            raise
        except Exception as e:
            raise ErrCorrupt(f"flat segment open failed: {e}")

    # ---------------- device ----------------

    def device_state(self, device) -> dict:
        """The scan state on `device`, made once. Unquantized: the f32 table,
        its row norms and a bf16 scan copy (it halves the bytes of every bf16
        scan). Quantized: the code arrays only, byte for byte as stored;
        never a decoded or f32 copy of the table."""
        device = torch.device(device)
        if self._dev is None or next(iter(self._dev.values())).device != device:
            dev = {k: common.enc_tensor(v, device) for k, v in self.enc_host.items()}
            if self.quant.kind == "none":
                dev["vectors16"] = dev["vectors"].to(torch.bfloat16)
            self._dev = dev
        return self._dev

    def release_device(self):
        self._dev = None
        self._cent_dev = None

    def device_bytes(self) -> int:
        """Device footprint of device_state() (for DeviceBudget admission)."""
        total = sum(a.nbytes for a in self.enc_host.values())
        if self.quant.kind == "none":
            total += self.enc_host["vectors"].nbytes // 2  # the bf16 scan copy
        return int(total)

    def rerank_host(self, q, rows):
        """Exact rerank gathering the candidate rows from host memory."""
        return common.rerank_host_rows(q, rows, self.vectors, self.rnorm2, self.metric)

    def stream_state(self, transport: str = "sq8", device="cuda"):
        """(enc_host, scanner): coded transport for beyond-device streaming
        of an *unquantized* segment (a quantized one streams its own codes
        through search_streaming). "sq8" ships 1 B/dim; "pq" ships d/2 B/row
        and is coarser, so callers pool at least 128 and rerank exactly
        (engine/search.py does). Built once per transport; `device` is where
        the PQ transport trains and assigns."""
        if transport not in self._streams:
            mk = common.pq_stream_state if transport == "pq" else common.sq8_stream_state
            self._streams[transport] = mk(self.vectors, self.metric.compute(), device=device)
        return self._streams[transport]

    def _probes(self, q, nprobes: int):
        """[B, nprobes] nearest partitions per query, or None for the full
        scan (no partitions, nprobes <= 0 or >= partitions)."""
        if (self.ivf_centroids is None or nprobes <= 0
                or nprobes >= int(self.meta["ivf"]["partitions"])):
            return None
        if self._cent_dev is None or self._cent_dev.device != q.device:
            self._cent_dev = common.enc_tensor(self.ivf_centroids, q.device)
        _, probes = T.topk_smallest(D.squared_l2(q, self._cent_dev), nprobes)
        return probes

    def _scan(self, q, k, scan_one, probes):
        """One running top-k over the whole segment, or, with probes, over
        each probed partition's row range for the queries that probe it.
        scan_one(queries, (r0, r1) or None) -> (d, rows)."""
        if probes is None:
            return scan_one(q, None)
        return T.probed_topk(q, k, probes, self._part_bounds,
                             lambda qs, r0, r1: scan_one(q[qs], (r0, r1)))

    # ---------------- search ----------------

    def search(self, q, k: int, mask=None, nprobes: int = 0, block_rows: int = 131072,
               scan_dtype: str = "bf16"):
        """Top-k over the segment. q [B, d] f32 on the device (normalized
        upstream for cosine); mask bool [n] (filters and tombstones), host or
        device. Returns (dists [B, k] f32, rows [B, k] int64).

        Unquantized: a pool scan over the bf16 copy (POOL_MARGIN_BF16 past k)
        or the f32 table (POOL_MARGIN_F32 past k), then an exact fp32 rerank of
        the pool: the distances are exact. Quantized: the quantizer's
        approximate distances over the codes; callers rerank (`rerank`)."""
        b = q.shape[0]
        if self.n == 0:
            return (torch.full((b, k), math.inf, device=q.device),
                    torch.full((b, k), -1, dtype=torch.int64, device=q.device))
        dev = self.device_state(q.device)
        dmask = torch.as_tensor(mask, dtype=torch.bool, device=q.device) if mask is not None else None
        probes = self._probes(q, nprobes)
        if self.quant.kind != "none":
            scanner = T.BlockScanner(self.quant, self.metric)
            return self._scan(q, k, lambda qq, rows: T.blockwise_topk_scored(
                qq, dev, self.n, k, scanner, mask=dmask, block_rows=block_rows, rows=rows), probes)
        bf16 = scan_dtype == "bf16"
        pool = min(self.n, k + (POOL_MARGIN_BF16 if bf16 else POOL_MARGIN_F32))
        if probes is None:
            return T.scored_pool_rerank(
                q, dev["vectors16"] if bf16 else dev["vectors"], dev["vectors"], dev["rnorm2"],
                k, pool, self.metric, dmask,
            )
        enc = {"vectors": dev["vectors16"] if bf16 else dev["vectors"], "rnorm2": dev["rnorm2"]}
        scanner = T.BlockScanner(self.quant, self.metric)
        _, rows = self._scan(q, pool, lambda qq, rr: T.blockwise_topk_scored(
            qq, enc, self.n, pool, scanner, mask=dmask, block_rows=block_rows, rows=rr), probes)
        return T.topk_smallest_with_ids(self.rerank(q, rows), rows, k)

    def search_streaming(self, q, k: int, mask=None, nprobes: int = 0,
                         block_rows: int = 131072):
        """Beyond-device search: the encoded arrays stay in host memory and
        row blocks stream through the device with a running top-k
        (`ops/topk.streaming_topk_scored`). A quantized segment returns what
        search() returns. An unquantized one streams its f32 rows and returns
        their exact f32 scores without a pool rerank, so ids can differ from
        search() where bf16 rounding reorders the pool's edge. Device memory
        stays O(block_rows)."""
        b = q.shape[0]
        if self.n == 0:
            return (torch.full((b, k), math.inf, device=q.device),
                    torch.full((b, k), -1, dtype=torch.int64, device=q.device))
        dmask = torch.as_tensor(mask, dtype=torch.bool, device=q.device) if mask is not None else None
        scanner = T.BlockScanner(self.quant, self.metric)
        return self._scan(q, k, lambda qq, rows: T.streaming_topk_scored(
            qq, self.enc_host, self.n, k, scanner, mask=dmask, block_rows=block_rows, rows=rows),
            self._probes(q, nprobes))

    # ---------------- gathered copies ----------------

    def gathered_bytes(self, rows: int, scan_dtype: str) -> int:
        """Device bytes of the copy `gather` makes of `rows` rows (what a
        device budget charges it)."""
        return rows * (2 * self.dim + 8 + 4 + (4 * self.dim if scan_dtype == "f32" else 0))

    def gather(self, rows_elig, scan_dtype: str) -> dict:
        """A dense device copy of an unquantized segment's rows `rows_elig`
        (int64, on the device): their segment row ids, their bf16 rows and
        their norms (f32), and under the f32 scan profile their f32 rows
        (`gathered_bytes` counts each). A low-selectivity filter scans it
        with `search_gathered` in O(rows) and without a mask."""
        dev = self.device_state(rows_elig.device)
        g = dict(rows=rows_elig, x16=dev["vectors"][rows_elig].to(torch.bfloat16),
                 rn=dev["rnorm2"][rows_elig])
        if scan_dtype == "f32":
            g["x32"] = dev["vectors"][rows_elig]
        return g

    def search_gathered(self, q, k: int, gathered: dict, scan_dtype: str):
        """Top-k over a copy that `gather` made with the same `scan_dtype`.
        Returns (dists [B, k] f32, segment rows [B, k] int64, -1 where
        empty). The f32 rows are scored exactly (on the card the split f32
        product); the bf16 rows give a pool POOL_MARGIN_GATHERED past k,
        reranked exactly against the segment's f32 table. Never reached
        through `search`, so a trace does not count its scans as scans of the
        whole segment."""
        if scan_dtype == "f32":
            d, lrows = T.blockwise_topk_search(
                q, gathered["x32"], k, metric=self.metric, x_norms_sq=gathered["rn"],
                x_normalized=True,
            )
            return d, torch.where(lrows >= 0, gathered["rows"][lrows.clamp_min(0)], -1)
        n_sub = gathered["x16"].shape[0]
        _, lrows = T.blockwise_topk_search(
            q, gathered["x16"], min(k + POOL_MARGIN_GATHERED, n_sub), metric=self.metric,
            x_norms_sq=gathered["rn"], x_normalized=True,
        )
        rows = torch.where(lrows >= 0, gathered["rows"][lrows.clamp_min(0)], -1)
        return T.topk_smallest_with_ids(self.rerank(q, rows), rows, k)

    def rerank(self, q, rows):
        """Exact fp32 distances of candidate rows [B, C] (-1 -> +inf). An
        unquantized segment reranks on the device (its stored vectors are
        full precision); a quantized one gathers the full-precision rows from
        the host, and only the candidate tile crosses to the device."""
        if self.quant.kind != "none":
            return self.rerank_host(q, rows)
        dev = self.device_state(q.device)
        return T.rerank_exact(q, rows, dev["vectors"], dev["rnorm2"], self.metric)

    # ---------------- host access ----------------

    def filter_mask(self, f) -> np.ndarray:
        return self.cm.filter_mask(f)

    # payload() / doc() provided by common.RowBlobAccess (lazy-aware).

    def vector(self, row: int) -> np.ndarray:
        return self.vectors[row]

    def iterate(self):
        """Yield (id, vector, doc, payload) for flush/compaction merges."""
        for row in range(self.n):
            yield int(self.ids[row]), self.vectors[row], self.doc(row), self.payload(row)
