"""Shared row buffering + section building for segment writers, the
beyond-device rerank from host rows and the SQ8/PQ stream transports (port of
vecgo_tpu/index/common.py)."""

from __future__ import annotations

import json
import math
from typing import Dict, List, Optional

import numpy as np
import torch

from vecgo_tpu_torch.errors import ErrDimensionMismatch, ErrInvalidVector
from vecgo_tpu_torch.metadata.columnar import ColumnarMeta
from vecgo_tpu_torch.model import Metric
from vecgo_tpu_torch.utils.tensors import host_tensor


class RowBuffer:
    """Accumulates (vector, id, metadata, payload) rows for a segment writer.

    Storage is chunked: add_batch appends whole (vectors, ids, lsns) arrays in
    O(1) (the engine's vectorized flush/compaction paths hand over full
    slabs); single add() rows accumulate in a pending list flushed to a chunk
    on demand. docs/payloads stay flat python lists (object-typed).
    """

    def __init__(self, dim: int):
        self.dim = dim
        self._chunks: List[tuple] = []  # (x [m,d] f32, ids [m] i64, lsns [m] i64)
        self._pv: List[np.ndarray] = []  # pending single rows
        self._pi: List[int] = []
        self._pl: List[int] = []
        self._n = 0
        self.docs: List[Optional[dict]] = []
        self.payloads: List[Optional[bytes]] = []

    def add(self, vector, id: int, metadata=None, payload: Optional[bytes] = None,
            lsn: int = 0):
        v = np.asarray(vector, np.float32).reshape(-1)
        if v.shape[0] != self.dim:
            raise ErrDimensionMismatch(f"got {v.shape[0]}, want {self.dim}")
        if not np.isfinite(v).all():
            raise ErrInvalidVector("vector contains NaN/Inf")
        self._pv.append(v)
        self._pi.append(int(id))
        self._pl.append(int(lsn))
        self.docs.append(metadata)
        self.payloads.append(payload)
        self._n += 1

    def add_batch(self, vectors, ids, metadatas=None, payloads=None, lsns=None):
        vectors = np.ascontiguousarray(vectors, np.float32)
        n = vectors.shape[0]
        if n == 0:
            return
        if vectors.shape[1] != self.dim:
            raise ErrDimensionMismatch(f"got {vectors.shape[1]}, want {self.dim}")
        if not np.isfinite(vectors).all():
            raise ErrInvalidVector("batch contains NaN/Inf")
        self._flush_pending()
        self._chunks.append(
            (
                vectors,
                np.asarray(ids, np.int64),
                np.asarray(lsns, np.int64) if lsns is not None else np.zeros(n, np.int64),
            )
        )
        self.docs.extend(metadatas if metadatas is not None else [None] * n)
        self.payloads.extend(payloads if payloads is not None else [None] * n)
        self._n += n

    def _flush_pending(self):
        if self._pv:
            self._chunks.append(
                (
                    np.stack(self._pv),
                    np.asarray(self._pi, np.int64),
                    np.asarray(self._pl, np.int64),
                )
            )
            self._pv, self._pi, self._pl = [], [], []

    def __len__(self):
        return self._n

    def _materialize(self):
        self._flush_pending()
        if len(self._chunks) != 1:
            x = (
                np.concatenate([c[0] for c in self._chunks])
                if self._chunks
                else np.zeros((0, self.dim), np.float32)
            )
            ids = (
                np.concatenate([c[1] for c in self._chunks])
                if self._chunks
                else np.zeros(0, np.int64)
            )
            lsns = (
                np.concatenate([c[2] for c in self._chunks])
                if self._chunks
                else np.zeros(0, np.int64)
            )
            self._chunks = [(x, ids, lsns)]
        return self._chunks[0]

    @property
    def ids(self) -> np.ndarray:
        return self._materialize()[1]

    @property
    def lsns(self) -> np.ndarray:
        return self._materialize()[2]

    def stacked(self, metric: Metric):
        """Returns (x [N,d] f32 — normalized for cosine, ids [N] u64)."""
        x, ids, _ = self._materialize()
        if metric == Metric.COSINE and len(ids):
            x = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-30)
        return x, ids.astype(np.uint64)

    def reorder(self, order: np.ndarray):
        x, ids, lsns = self._materialize()
        self._chunks = [(x[order], ids[order], lsns[order])]
        self.docs = [self.docs[i] for i in order]
        self.payloads = [self.payloads[i] for i in order]


def csr_bytes_sections(
    items: List[Optional[bytes]], prefix: str
) -> Dict[str, np.ndarray]:
    """Byte blobs -> CSR sections {prefix.data, prefix.indptr} (empty if all None)."""
    if not any(items):  # C-speed scan beats a 1M-iteration build loop
        return {}
    blob = bytearray()
    indptr = np.zeros(len(items) + 1, np.int64)
    any_data = False
    for i, p in enumerate(items):
        if p:
            blob.extend(p)
            any_data = True
        indptr[i + 1] = len(blob)
    if not any_data:
        return {}
    return {
        f"{prefix}.data": np.frombuffer(bytes(blob), np.uint8),
        f"{prefix}.indptr": indptr,
    }


def docs_sections(docs: List[Optional[dict]]) -> Dict[str, np.ndarray]:
    if all(d is None for d in docs):  # bulk-ingest common case: no docs
        return {}  # ({} docs still encode -- `is None` keeps that contract)
    enc = [
        json.dumps(d, separators=(",", ":")).encode() if d is not None else None
        for d in docs
    ]
    return csr_bytes_sections(enc, "docs")


def row_sections(x: np.ndarray, ids: np.ndarray, docs, payloads, lsns=None):
    """Common sections: vectors/norms/ids/lsns/metadata columns/payloads/docs."""
    sections: Dict[str, np.ndarray] = {
        "vectors": x,
        "rnorm2": np.einsum("nd,nd->n", x, x, dtype=np.float64).astype(np.float32),
        "ids": ids,
        "lsns": np.asarray(
            lsns if lsns is not None else np.zeros(len(ids)), np.int64
        ),
    }
    cm = ColumnarMeta.from_docs(docs)
    md_meta, md_sections = cm.to_sections()
    sections.update(md_sections)
    sections.update(csr_bytes_sections(payloads, "payload"))
    sections.update(docs_sections(docs))
    return sections, md_meta, cm


def csr_lookup(data: Optional[np.ndarray], indptr: Optional[np.ndarray], row: int):
    if data is None:
        return None
    s, e = indptr[row], indptr[row + 1]
    if e <= s:
        return None
    return data[s:e].tobytes()


class RowBlobAccess:
    """Shared docs/payload CSR access for immutable segments, with optional
    LAZY materialization: remote (ranged-read) opens skip the docs/payload
    sections entirely; the first doc()/payload() touch pulls each section with
    one ranged read (reference: diskann payload stream read-on-Fetch,
    segment.go Fetch*; lazy block reads :1151)."""

    def _attach_row_blobs(self, sections, lazy=None):
        self._lazy = lazy
        self._payload_data = sections.get("payload.data")
        self._payload_indptr = sections.get("payload.indptr")
        self._docs_data = sections.get("docs.data")
        self._docs_indptr = sections.get("docs.indptr")
        self._doc_cache = {}

    def _ensure_blob(self, prefix: str) -> None:
        if (
            getattr(self, f"_{prefix}_data") is None
            and self._lazy is not None
            and self._lazy.has(f"{prefix}.data")
        ):
            setattr(self, f"_{prefix}_data", self._lazy.load(f"{prefix}.data"))
            setattr(self, f"_{prefix}_indptr", self._lazy.load(f"{prefix}.indptr"))

    def payload(self, row: int) -> Optional[bytes]:
        self._ensure_blob("payload")
        return csr_lookup(self._payload_data, self._payload_indptr, row)

    def doc(self, row: int) -> Optional[dict]:
        cached = self._doc_cache.get(row, False)
        if cached is not False:
            return cached
        d = self._doc_uncached(row)
        if len(self._doc_cache) > 65536:
            self._doc_cache.clear()
        self._doc_cache[row] = d
        return d

    def _doc_uncached(self, row: int) -> Optional[dict]:
        self._ensure_blob("docs")
        if self._docs_data is not None:
            s, e = self._docs_indptr[row], self._docs_indptr[row + 1]
            if e > s:
                return json.loads(self._docs_data[s:e].tobytes())
            return None
        return self.cm.doc(row)


def csr_select(data, indptr, rows: np.ndarray):
    """CSR row gather for byte-blob sections; (None, None) stays absent."""
    from vecgo_tpu_torch.metadata.columnar import _csr_take

    if data is None:
        return None, None
    return _csr_take(np.asarray(data), np.asarray(indptr), np.asarray(rows, np.int64))


def csr_concat(parts):
    """Concat CSR parts [(data|None, indptr|None, n_rows)]; returns
    (data, indptr) or (None, None) when every part is empty."""
    lens, datas = [], []
    any_data = False
    for data, indptr, n in parts:
        if data is None:
            lens.append(np.zeros(n, np.int64))
        else:
            lens.append(np.diff(np.asarray(indptr)).astype(np.int64))
            datas.append(np.asarray(data))
            any_data = any_data or len(data) > 0
    if not any_data:
        return None, None
    lens = np.concatenate(lens)
    indptr = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=indptr[1:])
    data = np.concatenate(datas) if datas else np.zeros(0, np.uint8)
    return data, indptr


def preset_row_sections(x: np.ndarray, ids: np.ndarray, lsns, preset, order=None):
    """row_sections twin for the compaction SLAB path: docs/payload CSR and
    columnar metadata arrive pre-merged (vectorized) instead of per-row
    Python objects (VERDICT r2 #8 — at 1M rows the per-row json.loads path
    costs minutes; slabs move in milliseconds).

    preset = (ColumnarMeta, (docs_data, docs_indptr), (pay_data, pay_indptr))
    aligned with add order; `order` (writer row permutation, e.g. flat IVF
    reorder) is applied to every row-aligned structure."""
    cm, docs_csr, pay_csr = preset
    if order is not None:
        cm = cm.select(order)
        docs_csr = csr_select(docs_csr[0], docs_csr[1], order)
        pay_csr = csr_select(pay_csr[0], pay_csr[1], order)
    sections: Dict[str, np.ndarray] = {
        "vectors": x,
        "rnorm2": np.einsum("nd,nd->n", x, x, dtype=np.float64).astype(np.float32),
        "ids": ids,
        "lsns": np.asarray(
            lsns if lsns is not None else np.zeros(len(ids)), np.int64
        ),
    }
    md_meta, md_sections = cm.to_sections()
    sections.update(md_sections)
    if pay_csr[0] is not None:
        sections["payload.data"] = np.asarray(pay_csr[0], np.uint8)
        sections["payload.indptr"] = pay_csr[1]
    if docs_csr[0] is not None:
        sections["docs.data"] = np.asarray(docs_csr[0], np.uint8)
        sections["docs.indptr"] = docs_csr[1]
    return sections, md_meta, cm


def enc_tensor(arr: np.ndarray, device) -> torch.Tensor:
    """A host code array on `device` with its bytes unchanged (`host_tensor`:
    uint32 words as int32, uint16 codes as int16)."""
    return host_tensor(arr).to(device)


def rerank_host_rows(q: torch.Tensor, rows: torch.Tensor, vectors_host: np.ndarray,
                     rnorm2_host: np.ndarray, metric) -> torch.Tensor:
    """Exact rerank for a segment without its full-precision rows on the
    device (a quantized segment, or one streamed beyond the device budget):
    `rows` [B, C] is read back to the host (a sync), the candidate vectors are
    gathered there, and only the [B, C, d] tile is uploaded. Returns [B, C]
    f32 distances on q's device (-1 -> +inf), in IEEE f32."""
    from vecgo_tpu_torch.ops import distance as D

    metric = (Metric(metric) if not isinstance(metric, Metric) else metric).compute()
    rows_np = rows.cpu().numpy()
    safe = np.maximum(rows_np, 0)
    v = torch.from_numpy(np.ascontiguousarray(vectors_host[safe], np.float32))
    rn = torch.from_numpy(np.asarray(rnorm2_host[safe], np.float32))
    if q.device.type == "cuda":
        v, rn = v.pin_memory(), rn.pin_memory()
    v = v.to(q.device, non_blocking=True)
    rn = rn.to(q.device, non_blocking=True)
    qf = q.float()
    if metric == Metric.COSINE:
        qf = D.normalize(qf)
    prod = torch.einsum("bcd,bd->bc", v, qf)
    if metric == Metric.L2:
        d = ((qf * qf).sum(-1, keepdim=True) + rn - 2.0 * prod).clamp_min(0.0)
    elif metric == Metric.DOT:
        d = -prod
    else:
        d = 1.0 - prod
    return torch.where(rows >= 0, d, math.inf)


def raw_scanner(metric):
    """Block scanner over {"vectors", "rnorm2"} blocks of full-precision rows
    (streaming scans of a segment's own host arrays)."""
    from vecgo_tpu_torch import quantization as Q
    from vecgo_tpu_torch.ops.topk import BlockScanner

    return BlockScanner(Q.create("none", dim=0), metric)


def _coded_stream_state(kind: str, vectors: np.ndarray, metric, device, **params):
    from vecgo_tpu_torch import quantization as Q
    from vecgo_tpu_torch.ops.topk import BlockScanner

    n, d = vectors.shape
    quant = Q.create(kind, device=device, dim=d, **params)
    quant.train(np.asarray(vectors[:: max(1, n // 65536)], np.float32))
    enc = {k: np.asarray(v) for k, v in quant.encode(np.asarray(vectors, np.float32)).items()}
    return enc, BlockScanner(quant, metric)


def sq8_stream_state(vectors: np.ndarray, metric, device="cuda"):
    """(enc_host, scanner) for beyond-device streaming over SQ8 codes: one
    byte a dimension crosses to the device instead of four. The winners get
    an exact host rerank downstream (`rerank_host_rows`)."""
    return _coded_stream_state("sq8", vectors, metric, device)


def pq_stream_state(vectors: np.ndarray, metric, m: int = 0, device="cuda"):
    """(enc_host, scanner) for beyond-device streaming over PQ codes: d/2
    bytes a row (m = d/2 subspaces of one byte) plus a 4-byte reconstruction
    norm. The coded ordering is coarser than SQ8's, so callers must pool at
    least 128 candidates and rerank exactly from host rows (engine/search.py
    does). m = d/2 with a pool of 128 is carried over from the JAX package as
    a design choice: it was picked there on a recall screen run on a TPU
    (m = d/4 needed a 512-wide pool to clear 0.99); the card's recall at this
    setting is measured by chip_smoke.py. Pass m for another setting."""
    n, d = vectors.shape
    return _coded_stream_state("pq", vectors, metric, device, m=m or max(4, d // 2))
