"""Flat (brute-force) segment of the port (vecgo_tpu/index/flat.py).

The container format is shared: `FlatWriter` writes the same bytes as the
JAX writer, and either package opens the other's segments. The segment
subclasses the JAX `FlatSegment` so that the imported planner
(`vecgo_tpu.engine.search._plan_snapshot`) recognises it; every method that
touches the device is overridden here, and the JAX constructor (whose
quantizer registry loads jax) is never called.
"""

from __future__ import annotations

import math
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from vecgo_tpu.errors import ErrCorrupt
from vecgo_tpu.index import common
from vecgo_tpu.index import flat as jax_flat
from vecgo_tpu.index.flat import SEGMENT_KIND, segment_stats
from vecgo_tpu.metadata.columnar import ColumnarMeta
from vecgo_tpu.model import Metric
from vecgo_tpu.storage import container
from vecgo_tpu_torch import quantization as Q
from vecgo_tpu_torch._roadmap import not_ported
from vecgo_tpu_torch.ops import topk as T


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


class FlatSegment(jax_flat.FlatSegment):
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
