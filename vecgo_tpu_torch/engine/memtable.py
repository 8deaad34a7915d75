"""Device half of the memtable (port of vecgo_tpu/engine/memtable.py:377-455).

The host half — slab-chain storage, inserts, deletes, metadata filters — is
the JAX package's `MemTable`, inherited unchanged. Rows freeze into
immutable CHUNK-row device chunks as they accumulate; the rows past the last
full chunk (the tail) upload on every search. Each chunk and the tail are
scanned by `scan_topk` with their slice of the mask.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from vecgo_tpu.engine import memtable as jax_memtable
from vecgo_tpu.engine.memtable import CHUNK
from vecgo_tpu_torch.ops import topk as T


def _upload(rows: np.ndarray, device):
    vec = torch.from_numpy(np.ascontiguousarray(rows, np.float32)).to(device)
    rn = np.einsum("nd,nd->n", rows, rows, dtype=np.float64).astype(np.float32)
    return vec, torch.from_numpy(rn).to(device)


class MemTable(jax_memtable.MemTable):
    def __init__(self, dim: int, metric):
        super().__init__(dim, metric)
        self._tail_dev = None  # ((start, end), vec, rn) of the last tail upload

    def release_device(self):
        """Drop the device chunks; they upload again on the next search."""
        with self._lock:
            self._chunks = []
            self._frozen_rows = 0
            self._tail_dev = None

    def _sync_chunks(self, device):
        if self._chunks and self._chunks[0][0].device != device:
            self.release_device()
        while self._frozen_rows + CHUNK <= self._n:
            s = self._frozen_rows
            self._chunks.append(_upload(self.rows_view(s, s + CHUNK), device))
            self._frozen_rows += CHUNK

    def _tail_rows(self, s: int, e: int, device):
        """Rows [s, e) past the frozen chunks on the device. Rows never change
        once written, so one upload serves every search until rows arrive."""
        if self._tail_dev is None or self._tail_dev[0] != (s, e) \
                or self._tail_dev[1].device != device:
            self._tail_dev = ((s, e), *_upload(self.rows_view(s, e), device))
        return self._tail_dev[1:]

    def search(self, q, k: int, n_visible: int, mask=None):
        """Exact top-k over rows [0, n_visible). q [B, d] f32 on the device
        (normalized upstream for cosine); mask bool [n_visible], host or
        device. Returns (dists [B, k] f32, rows [B, k] int64)."""
        b = q.shape[0]
        # (+inf, -1) padding goes last so a short result still has k columns.
        ds = [torch.full((b, k), math.inf, device=q.device)]
        rows = [torch.full((b, k), -1, dtype=torch.int64, device=q.device)]
        if n_visible == 0:
            return ds[0], rows[0]
        self._sync_chunks(q.device)
        if mask is not None:
            mask = torch.as_tensor(mask, dtype=torch.bool, device=q.device)
        n_frozen = min(self._frozen_rows, n_visible)
        for s in range(0, n_visible, CHUNK):
            e = min(s + CHUNK, n_visible)
            if s < n_frozen:
                vec, rn = self._chunks[s // CHUNK]
                vec, rn = vec[: e - s], rn[: e - s]
            else:
                vec, rn = self._tail_rows(s, e, q.device)
            d, i = T.blockwise_topk_search(
                q, vec, min(k, e - s), metric=self.metric, x_norms_sq=rn,
                mask=None if mask is None else mask[s:e], x_normalized=True,
            )
            ds.insert(-1, d)
            rows.insert(-1, torch.where(i >= 0, i + s, -1))
        d, i = T.topk_smallest_with_ids(torch.cat(ds, 1), torch.cat(rows, 1), k)
        return d, torch.where(torch.isfinite(d), i, -1)
