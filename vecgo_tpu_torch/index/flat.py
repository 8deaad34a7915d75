"""Flat (brute-force) segment of the port (vecgo_tpu/index/flat.py).

The container format is shared: `FlatWriter` writes the same bytes as the
JAX writer, and either package opens the other's segments. Host code
(segment stats, the categorical blooms the planner prunes by, row access) is
the JAX module's; the device state and the scans are the port's.
"""

from __future__ import annotations

import math
import warnings
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from vecgo_tpu_torch import quantization as Q
from vecgo_tpu_torch.errors import ErrCorrupt
from vecgo_tpu_torch.index import common
from vecgo_tpu_torch.metadata.columnar import ColumnarMeta
from vecgo_tpu_torch.model import Metric
from vecgo_tpu_torch.storage import container
from vecgo_tpu_torch._roadmap import not_ported
from vecgo_tpu_torch.ops import topk as T


SEGMENT_KIND = "flat"


def _to_device(arr: np.ndarray, device) -> torch.Tensor:
    """A float32 host section on `device`. Sections are often read-only views
    of the container; device state is never written, so sharing them (on the
    CPU) is safe and torch's warning about it is silenced."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(device)


class FlatWriter:
    """Buffered writer: add rows, then finish() -> container bytes."""

    def __init__(
        self,
        dim: int,
        metric: Metric = Metric.L2,
        quantizer: str = "none",
        qparams: Optional[dict] = None,
        ivf_partitions: int = 0,
        seed: int = 42,
        compress: str = "",
    ):
        if ivf_partitions > 1:
            raise not_ported("flat IVF partitioning", 2)
        self.dim = dim
        self.metric = metric
        self.quant = Q.create(quantizer, dim=dim, **dict(qparams or {}))
        self.seed = seed
        self.compress = compress
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
        x, ids = self._rows.stacked(self.metric)
        if self._preset is not None:
            sections, md_meta, cm = common.preset_row_sections(
                x, ids, self._rows.lsns, self._preset
            )
        else:
            sections, md_meta, cm = common.row_sections(
                x, ids, self._rows.docs, self._rows.payloads, self._rows.lsns
            )
        self.quant.train(x, seed=self.seed)
        meta = {
            "kind": SEGMENT_KIND,
            "dim": self.dim,
            "metric": self.metric.value,
            "count": len(self._rows),
            "quantizer": {"kind": self.quant.kind, "params": self.quant.params()},
            "ivf": {"partitions": 0},
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
    """Immutable flat segment: host arrays plus a lazily built device state."""

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
        self.quant = Q.NoneQuantizer.from_state(
            {"kind": meta["quantizer"]["kind"], "params": meta["quantizer"]["params"]}
        )
        # Flat IVF partitions (written by compaction) only prune probes; the
        # exact full scan ignores them.
        self.ivf_centroids = sections.get("ivf.centroids")
        self.ivf_part = sections.get("ivf.part")
        self.cm = ColumnarMeta.from_sections(meta["metadata"], sections)
        self._attach_row_blobs(sections, lazy)
        self._dev: Optional[dict] = None

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
        """The f32 table, its row norms and a bf16 scan copy on `device`
        (made once; the bf16 copy halves the bytes of every bf16 scan)."""
        device = torch.device(device)
        if self._dev is None or self._dev["vectors"].device != device:
            vec = _to_device(self.vectors, device)
            self._dev = {
                "vectors": vec,
                "rnorm2": _to_device(self.rnorm2, device),
                "vectors16": vec.to(torch.bfloat16),
            }
        return self._dev

    def release_device(self):
        self._dev = None

    def device_bytes(self) -> int:
        """Device footprint of device_state(): f32 table, norms, bf16 copy."""
        return int(self.vectors.nbytes + self.rnorm2.nbytes + self.vectors.nbytes // 2)

    # ---------------- search ----------------

    def search(self, q, k: int, mask=None, scan_dtype: str = "bf16"):
        """Top-k over the segment: a pool scan over the bf16 copy (k+8 wide)
        or the f32 table (k+16 wide, for tie-heavy data), then an exact fp32
        rerank of the pool. q [B, d] f32 on the device (normalized upstream
        for cosine); mask bool [n] (filters and tombstones), host or device.
        Returns (dists [B, k] f32, rows [B, k] int64)."""
        b = q.shape[0]
        if self.n == 0:
            return (torch.full((b, k), math.inf, device=q.device),
                    torch.full((b, k), -1, dtype=torch.int64, device=q.device))
        dev = self.device_state(q.device)
        bf16 = scan_dtype == "bf16"
        dmask = torch.as_tensor(mask, dtype=torch.bool, device=q.device) if mask is not None else None
        return T.scored_pool_rerank(
            q, dev["vectors16"] if bf16 else dev["vectors"], dev["vectors"], dev["rnorm2"],
            k, min(self.n, k + (8 if bf16 else 16)), self.metric, dmask,
        )

    def rerank(self, q, rows):
        """Exact fp32 distances of candidate rows [B, C] (-1 -> +inf)."""
        dev = self.device_state(q.device)
        return T.rerank_exact(q, rows, dev["vectors"], dev["rnorm2"], self.metric)

    def rerank_host(self, *args, **kw):
        raise not_ported("beyond-device rerank from host rows", 2)

    def search_streaming(self, *args, **kw):
        raise not_ported("beyond-device streaming search", 2)

    def stream_state(self, *args, **kw):
        raise not_ported("beyond-device stream transports", 2)

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
