"""Device-resident BM25 serving: the port of vecgo_tpu/lexical/device_bm25.py.

The JAX class turns BM25 scoring into dense linear algebra: the per-(doc,
hot term) weight

    w[d, t] = idf_t * tf * (k1+1) / (tf + k1 * (1 - b + b * len_d / avg_len))

of the HOT vocabulary (live df >= min_df, sorted by (-df, term), capped at
max_hot_terms) lives on the device as an [n_slots, H] bf16 table, and a
query batch is scored by one sweep of its multi-hot [B, H] query against
that table with a running top-k, then an exact f32 rescore of the pool.
RARE terms (below min_df, or hot terms past the 16th of a query) merge on
the host exactly: candidates = the device pool (exact-rescored) plus the
rare postings' docs. A doc outside both has a hot-only score below the
pool's floor and no rare boost, so the merge is exact up to bf16 weight
quantization.

The port keeps that contract and its numbers (the table is bit for bit the
JAX class's; the pool holds the same rows) in PyTorch's idiom:

- the table is built on the device by one `index_put_` of the hot postings'
  (slot, column, f32 weight) triples, rounded to bf16 there. No [n_slots, H]
  array exists on the host (at 1M docs x 4096 terms the JAX class's f32 host
  matrix is 17.2 GB). Its width is padded with zero columns to a multiple
  of 64, which changes no score and keeps the kernel on 16-byte loads;
- per batch only the [B, 16] int32 term columns go up;
- the sweep is `ops/scan_topk.scan_topk_columns` over the bf16 table, the
  dead slots as its mask (on a CUDA tensor the kernel, on a CPU tensor its
  plain version): each slot's score is the f32 sum of the query's own
  columns, the function of the JAX class's dense product of the multi-hot
  query (whose other terms are exact zeros), from the table read once.
  No multi-hot query is built on the path;
- the rescore gathers each query's <= 16 hot columns of its pool rows, a
  [B, kk, 16] tensor, and sums them in IEEE f32; a stable sort by (-score,
  pool position) follows, as `jax.lax.sort(..., num_keys=1)` does;
- the rare merge takes the hot part of a rare-only candidate from the
  device table, every rare query of the batch in one gather and one D2H.

The snapshot reads the index's postings only below its own slot count, so
a table rebuilt after `release_device()` (or a rare term read later) is the
snapshot's even if the index has taken writes since.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from vecgo_tpu_torch.lexical.bm25 import BM25Index, tokenize
from vecgo_tpu_torch.ops.scan_topk import scan_topk_columns
from vecgo_tpu_torch.utils.tensors import checked_device

_TMAX = 16  # max hot terms per query on the device path
_COL_ALIGN = 64  # the table's width is padded to a multiple of this


class DeviceBM25:
    """Immutable device-resident BM25 scorer over a BM25Index snapshot, on
    `device` ("cuda" by default; "cpu" runs the kernel's plain version)."""

    def __init__(
        self,
        index: BM25Index,
        max_hot_terms: int = 4096,
        min_df: int = 8,
        pool_margin: int = 16,
        device="cuda",
    ):
        self.device = checked_device(device, "DeviceBM25")
        self.index = index
        self.pool_margin = pool_margin
        self.hot: Dict[str, int] = {}
        self.avg_len = 1.0
        self.doc_len = np.zeros(0, np.float32)
        self._rare_w: Dict[str, Optional[tuple]] = {}
        self._w = self._alive_d = None  # the device table and its alive mask
        with index._lock:
            n_docs = sum(index._alive)
            n_slots = len(index._slot_id)
            self.n_slots = n_slots
            self.n_docs = n_docs
            self.slot_id = np.asarray(index._slot_id, np.int64) if n_slots else (
                np.zeros(0, np.int64)
            )
            self.alive = np.asarray(index._alive, bool) if n_slots else (
                np.zeros(0, bool)
            )
            if n_docs == 0:
                return
            self.avg_len = index._total_len / n_docs
            self.doc_len = np.asarray(index._doc_len, np.float32)
            # hot vocabulary: by live document frequency
            dfs = []
            for t, (slots, tfs) in index._postings.items():
                df = int(self.alive[self._snapshot_slots(slots)].sum())
                if df >= min_df:
                    dfs.append((df, t))
            dfs.sort(key=lambda x: (-x[0], x[1]))
            self.hot = {t: i for i, (_, t) in enumerate(dfs[:max_hot_terms])}
            if self.hot:
                self._build_locked()

    @property
    def width(self) -> int:
        """Columns of the device table: H padded to a multiple of 64."""
        return -(-max(len(self.hot), 1) // _COL_ALIGN) * _COL_ALIGN

    def _snapshot_slots(self, slots) -> np.ndarray:
        """A postings list's slots that existed when the snapshot was taken
        (postings only grow, in slot order)."""
        slots = np.asarray(slots, np.int64)
        return slots[: np.searchsorted(slots, self.n_slots)]

    def _weights_for(self, t: str) -> Tuple[np.ndarray, np.ndarray]:
        """(live slots, f32 BM25 weights) for one term: the JAX class's
        expression, so the same numpy gives the same bits."""
        idx = self.index
        slots, tfs = idx._postings[t]
        slots = self._snapshot_slots(slots)
        tfs = np.asarray(tfs[: len(slots)], np.float32)
        live = self.alive[slots]
        slots, tfs = slots[live], tfs[live]
        df = len(slots)
        if df == 0:
            return slots, tfs
        idf = np.log(1.0 + (self.n_docs - df + 0.5) / (df + 0.5))
        denom = tfs + idx.k1 * (
            1.0 - idx.b + idx.b * self.doc_len[slots] / max(self.avg_len, 1e-9)
        )
        return slots, (idf * tfs * (idx.k1 + 1.0) / denom).astype(np.float32)

    def _build_locked(self):
        """The [n_slots, width] bf16 table on the device: one index_put_ of
        the hot postings' (slot, column, f32 weight) triples, rounded to bf16
        (to nearest even) on the device. Holds the index's lock."""
        parts = [(*self._weights_for(t), col) for t, col in self.hot.items()]
        flat = np.concatenate([s * self.width + col for s, _, col in parts])
        wts = np.concatenate([w for _, w, _ in parts])
        table = torch.zeros((self.n_slots, self.width), dtype=torch.bfloat16, device=self.device)
        table.view(-1).index_put_((torch.from_numpy(flat).to(self.device),),
                                  torch.from_numpy(wts).to(self.device).to(torch.bfloat16))
        self._set_table(table)

    def _set_table(self, table: torch.Tensor):
        """Adopt an [n_slots, <= width] bf16 table (zero columns padded on)."""
        if table.shape[1] < self.width:
            table = torch.nn.functional.pad(table, (0, self.width - table.shape[1]))
        self._w = table.to(self.device).contiguous()
        self._alive_d = torch.from_numpy(self.alive).to(self.device)

    def _rare(self, t: str) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Cached postings weights for a rare (non-hot) indexed term."""
        got = self._rare_w.get(t, False)
        if got is not False:
            return got
        if t not in self.index._postings:
            self._rare_w[t] = None
            return None
        out = self._weights_for(t)
        if len(out[0]) == 0:
            out = None
        self._rare_w[t] = out
        return out

    def device_bytes(self) -> int:
        """Bytes of the device table (resident or not): n_slots x width x 2."""
        return self.n_slots * self.width * 2 if self.hot else 0

    def _device(self):
        if self._w is None:
            with self.index._lock:
                self._build_locked()
        return self._w, self._alive_d

    def release_device(self):
        """Drop the device table; the next search rebuilds it."""
        self._w = self._alive_d = None

    def encode_queries(self, queries: List[str]):
        """Returns (cols [B, T] int32 hot-term columns (-1 pad), rare [B]
        list-of-rare-indexed-terms)."""
        b = len(queries)
        cols = np.full((b, _TMAX), -1, np.int32)
        rare: List[List[str]] = [[] for _ in range(b)]
        for r, text in enumerate(queries):
            toks = sorted(set(tokenize(text)))
            j = 0
            for t in toks:
                col = self.hot.get(t)
                if col is not None:
                    if j < _TMAX:
                        cols[r, j] = col
                        j += 1
                    else:  # >T hot terms: treat overflow as rare (exact path)
                        rare[r].append(t)
                elif t in self.index._postings:
                    rare[r].append(t)
        return cols, rare

    def multi_hot(self, cols: np.ndarray):
        """(cols [B, T] int64, the multi-hot [B, width] f32 query) on the
        device from encode_queries' columns, -1 pads scattering nothing: the
        JAX class's query, the input of the dense function that the sweep
        computes from the columns (the card's checks hold it to that)."""
        cols_d = torch.from_numpy(cols).to(self.device).long()
        qd = torch.zeros((len(cols), self.width), dtype=torch.float32, device=self.device)
        qd.scatter_add_(1, cols_d.clamp_min(0), (cols_d >= 0).float())
        return cols_d, qd

    def search_batch_arrays(
        self, queries: List[str], k: int = 10
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Device-batch BM25: one `scan_topk_columns` sweep + exact-f32 pool rescore
        + exact host merge of rare-term contributions. Returns (ids [B, k]
        int64 with -1 padding, scores [B, k] f32)."""
        b = len(queries)
        if self.n_slots == 0 or not self.hot:
            hits = self.index.search_batch(queries, k)
            out_ids = np.full((b, k), -1, np.int64)
            out_sc = np.zeros((b, k), np.float32)
            for r, hs in enumerate(hits):
                for j, (id_, s) in enumerate(hs[:k]):
                    out_ids[r, j] = id_
                    out_sc[r, j] = s
            return out_ids, out_sc
        cols, rare = self.encode_queries(queries)
        w, alive = self._device()
        kk = min(k + self.pool_margin, self.n_slots)
        cols_d = torch.from_numpy(cols).to(self.device).long()
        used = cols_d >= 0
        safe_cols = cols_d.clamp_min(0)
        _, rows = scan_topk_columns(cols_d, w, kk, mask=alive)
        # Exact rescore over each query's own hot columns of its pool rows.
        picked = w[rows.long().clamp_min(0)[:, :, None], safe_cols[:, None, :]].float()
        s = torch.where(used[:, None, :], picked, 0.0).sum(-1)
        d_exact = torch.where(rows >= 0, -s, torch.inf)
        sd, order = torch.sort(d_exact, dim=1, stable=True)
        si = torch.gather(rows, 1, order)
        sd = sd.cpu().numpy()  # [B, kk] negated scores
        si = si.cpu().numpy()
        scores = -sd
        valid = np.isfinite(sd) & (scores > 0)
        out_ids = np.where(
            valid[:, :k], self.slot_id[np.maximum(si[:, :k], 0)], -1
        ).astype(np.int64)
        out_sc = np.where(valid[:, :k], scores[:, :k], 0.0).astype(np.float32)
        merges = []  # (row, candidates, rare-only slots)
        for r in range(b):
            if not rare[r]:
                continue
            rmap: Dict[int, float] = {}
            for t in rare[r]:
                pw = self._rare(t)
                if pw is None:
                    continue
                for slot, wt in zip(pw[0], pw[1]):
                    rmap[int(slot)] = rmap.get(int(slot), 0.0) + float(wt)
            cand = {
                int(si[r, j]): float(scores[r, j])
                for j in range(kk)
                if valid[r, j]
            }
            cand = {s_: sc + rmap.get(s_, 0.0) for s_, sc in cand.items()}
            extra = [(slot, rsc) for slot, rsc in rmap.items() if slot not in cand]
            merges.append((r, cand, extra))
        hot_parts = self._hot_parts(
            [(r, slot) for r, _, extra in merges for slot, _ in extra], cols_d, used)
        at = 0
        for r, cand, extra in merges:
            for slot, rsc in extra:
                cand[slot] = float(hot_parts[at]) + rsc
                at += 1
            top = sorted(cand.items(), key=lambda kv: (-kv[1], kv[0]))[:k]
            out_ids[r] = -1
            out_sc[r] = 0.0
            for j, (slot, sc) in enumerate(top):
                if sc <= 0:
                    break
                out_ids[r, j] = int(self.slot_id[slot])
                out_sc[r, j] = sc
        return out_ids, out_sc

    def _hot_parts(self, pairs, cols_d, used) -> np.ndarray:
        """The f32 hot-term score of each (query row, slot) pair from the
        device table: one gather and one D2H for the whole batch."""
        if not pairs:
            return np.zeros(0, np.float32)
        rs, slots = (torch.from_numpy(np.asarray(v, np.int64)).to(self.device)
                     for v in zip(*pairs))
        picked = self._w[slots[:, None], cols_d[rs].clamp_min(0)].float()
        return torch.where(used[rs], picked, 0.0).sum(-1).cpu().numpy()

    def search_batch(
        self, queries: List[str], k: int = 10
    ) -> List[List[Tuple[int, float]]]:
        """List-of-(id, score) wrapper over search_batch_arrays (the
        BM25Index.search_batch contract)."""
        ids, sc = self.search_batch_arrays(queries, k)
        return [
            [
                (int(ids[r, j]), float(sc[r, j]))
                for j in range(ids.shape[1])
                if ids[r, j] >= 0
            ]
            for r in range(len(queries))
        ]
