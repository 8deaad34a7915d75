"""FreshVamana: a mutable streaming graph index with soft deletes and
consolidation (port of vecgo_tpu/index/fresh.py).

Reference: internal/segment/diskann/fresh_vamana.go — copy-on-write growth
(:76-82), insert = greedy search + RobustPrune + reverse edges (:178-225,
:698), a soft-delete bitmap (:226), consolidate() when the deleted ratio is
high (:804-868).

Inserts are batched as in the JAX package: a block of new points runs one
lockstep beam search over the current device graph, one RobustPrune and one
row update; reverse edges are applied in bulk with a re-prune of the nodes
they reach. Capacity grows by doubling (the device tensors are reallocated
and the rows copied). Soft-deleted nodes stay traversable but are masked
out of results; consolidate() rebuilds the graph over the live rows with
the beam build (`index/vamana.build_graph`). The device tensors are updated
in place, where the JAX package updates functionally.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from vecgo_tpu_torch.model import Metric
from vecgo_tpu_torch.ops import beam as beam_ops

MIN_CAPACITY = 1024


class FreshVamana:
    """Streaming graph index on `device`. The parameters are the JAX
    index's; `seed` is accepted for its signature (nothing draws from it
    there either)."""

    def __init__(
        self,
        dim: int,
        metric: Metric = Metric.L2,
        r: int = 32,
        l_build: int = 64,
        alpha: float = 1.2,
        beam_width: int = 4,
        consolidate_threshold: float = 0.3,
        seed: int = 42,
        device="cuda",
    ):
        self.dim = dim
        self.metric = metric
        self.r = r
        self.l_build = l_build
        self.alpha = alpha
        self.beam_width = beam_width
        self.consolidate_threshold = consolidate_threshold
        self.device = torch.device(device)
        self.n = 0
        self.capacity = 0
        self.x = np.zeros((0, dim), np.float32)  # host mirror
        self.deleted = np.zeros(0, bool)
        self.medoid = 0
        self._dev = None  # full f32, trav bf16, rnorm2, graph; padded to capacity

    # ---------------- capacity ----------------

    def _ensure_capacity(self, need: int):
        if need <= self.capacity:
            return
        cap = max(MIN_CAPACITY, 1 << int(np.ceil(np.log2(need))))
        x = np.zeros((cap, self.dim), np.float32)
        x[: self.n] = self.x[: self.n]
        self.x = x
        deleted = np.zeros(cap, bool)
        deleted[: self.n] = self.deleted[: self.n]
        self.deleted = deleted
        graph = torch.full((cap, self.r), -1, dtype=torch.int32, device=self.device)
        if self._dev is not None:
            graph[: self.capacity] = self._dev["graph"]
        full = torch.from_numpy(self.x).to(self.device)
        self._dev = {"full": full, "trav": full.to(torch.bfloat16),
                     "rnorm2": (full * full).sum(1), "graph": graph}
        self.capacity = cap

    def _set_rows_device(self, rows: np.ndarray, vecs: np.ndarray):
        rows_d = torch.from_numpy(rows.astype(np.int64)).to(self.device)
        v = torch.from_numpy(vecs).to(self.device)
        self._dev["full"][rows_d] = v
        self._dev["trav"][rows_d] = v.to(torch.bfloat16)
        self._dev["rnorm2"][rows_d] = torch.from_numpy(
            np.einsum("nd,nd->n", vecs, vecs, dtype=np.float64).astype(np.float32)).to(self.device)

    # ---------------- insert ----------------

    def insert_batch(self, vectors: np.ndarray) -> np.ndarray:
        """Insert a block of vectors; returns their row indices."""
        vecs = np.ascontiguousarray(vectors, np.float32)
        if self.metric == Metric.COSINE:
            vecs = vecs / np.maximum(np.linalg.norm(vecs, axis=1, keepdims=True), 1e-30)
        c = vecs.shape[0]
        rows = np.arange(self.n, self.n + c)
        self._ensure_capacity(self.n + c)
        self.x[rows] = vecs
        first_batch = self.n == 0
        self.n += c
        self._set_rows_device(rows, vecs)
        if first_batch:
            self.medoid = int(((vecs - vecs.mean(0)) ** 2).sum(1).argmin())
        dev = self._dev
        rows_d = torch.from_numpy(rows).to(self.device)
        q_blk = dev["full"][rows_d]

        if first_batch or self.n <= self.r + 1:
            # Bootstrap: connect everything to everything (pruned).
            cand = torch.arange(self.n, device=self.device)[None, :].expand(c, -1)
        else:
            _, _, _, cand = beam_ops.beam_search(
                q_blk, dev["trav"], dev["rnorm2"], dev["graph"],
                torch.tensor([self.medoid], device=self.device), ef=self.l_build, k=1,
                beam_width=self.beam_width, with_visited=True)
        new_nbrs = beam_ops.robust_prune(rows_d, q_blk, cand, dev["full"], dev["rnorm2"],
                                         r_out=self.r, alpha=self.alpha)
        dev["graph"][rows_d] = new_nbrs.to(torch.int32)

        # Bulk reverse edges: each new point joins its neighbours' candidate
        # lists, and the nodes reached re-prune (reference :698).
        targets = new_nbrs.cpu().numpy().reshape(-1)
        srcs = np.repeat(rows, self.r)
        keep = targets >= 0
        targets, srcs = targets[keep], srcs[keep]
        if len(targets):
            uniq = np.unique(targets)
            width = min(self.r, 16)
            order = np.argsort(targets, kind="stable")
            t_sorted, s_sorted = targets[order], srcs[order]
            starts = np.searchsorted(t_sorted, uniq)
            take = np.minimum(np.searchsorted(t_sorted, uniq, side="right") - starts, width)
            extra = np.full((len(uniq), width), -1, np.int64)
            at = np.repeat(np.arange(len(uniq)), take)
            offs = np.arange(len(at)) - np.repeat(np.cumsum(take) - take, take)
            extra[at, offs] = s_sorted[np.repeat(starts, take) + offs]
            uniq_d = torch.from_numpy(uniq.astype(np.int64)).to(self.device)
            cand_all = torch.cat([dev["graph"][uniq_d].long(),
                                  torch.from_numpy(extra).to(self.device)], 1)
            pruned = beam_ops.robust_prune(uniq_d, dev["full"][uniq_d], cand_all, dev["full"],
                                           dev["rnorm2"], r_out=self.r, alpha=self.alpha)
            dev["graph"][uniq_d] = pruned.to(torch.int32)
        return rows

    # ---------------- delete / consolidate ----------------

    def delete(self, row: int):
        self.deleted[row] = True

    @property
    def deleted_ratio(self) -> float:
        return float(self.deleted[: self.n].mean()) if self.n else 0.0

    def maybe_consolidate(self) -> bool:
        if self.deleted_ratio >= self.consolidate_threshold:
            self.consolidate()
            return True
        return False

    def consolidate(self):
        """Rebuild over the live rows (the reference's consolidate() patches
        edges through deleted nodes; a batched rebuild gives the same graph
        quality). Returns the old row of each new row."""
        from vecgo_tpu_torch.index.vamana import build_graph

        live = ~self.deleted[: self.n]
        x_live = self.x[: self.n][live]
        n_new = x_live.shape[0]
        self.n = 0
        self.capacity = 0
        self._dev = None
        self.deleted = np.zeros(0, bool)
        self.x = np.zeros((0, self.dim), np.float32)
        if n_new == 0:
            return np.zeros(0, np.int64)
        self._ensure_capacity(n_new)
        self.x[:n_new] = x_live
        self.n = n_new
        self._set_rows_device(np.arange(n_new), x_live)
        graph, medoid, _, _ = build_graph(x_live, r=self.r, l_build=self.l_build,
                                          alpha=self.alpha, device=self.device)
        self._dev["graph"][:n_new] = torch.from_numpy(graph).to(self.device)
        self.medoid = medoid
        return np.flatnonzero(live)

    # ---------------- search ----------------

    def search(self, q, k: int, mask: Optional[np.ndarray] = None, ef: int = 0):
        """Beam search from the medoid; deleted rows are traversable but
        masked from results. q [B, d] tensor on the index's device or numpy.
        Returns (dists [B, k], rows [B, k] int64, -1 missing)."""
        q = torch.as_tensor(np.asarray(q, np.float32) if not isinstance(q, torch.Tensor) else q)
        q = q.to(self.device, torch.float32)
        b = q.shape[0]
        if self.n == 0:
            return (torch.full((b, k), math.inf, device=self.device),
                    torch.full((b, k), -1, dtype=torch.int64, device=self.device))
        ef = max(ef or self.l_build, k)
        full_mask = np.zeros(self.capacity, bool)
        full_mask[: self.n] = ~self.deleted[: self.n]
        if mask is not None:
            full_mask[: self.n] &= mask[: self.n]
        dev = self._dev
        return beam_ops.beam_search(
            q, dev["trav"], dev["rnorm2"], dev["graph"],
            torch.tensor([self.medoid], device=self.device), ef=ef, k=k,
            beam_width=self.beam_width, mask=torch.from_numpy(full_mask).to(self.device))
