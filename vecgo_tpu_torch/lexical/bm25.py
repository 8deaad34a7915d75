"""In-memory BM25 lexical index (reference: lexical/bm25/bm25.go:29-392 —
k1=1.2 b=0.75, DAAT scoring, ASCII fast-path tokenizer, O(terms) delete).

Host-side numpy implementation: postings are per-term (doc-idx, tf) arrays;
scoring is vectorized term-at-a-time accumulation (the numpy analogue of the
reference's pooled DAAT iterators).

The port's copy of vecgo_tpu/lexical/bm25.py (numpy and threading only):
the same tokenizer, postings, f64 weights and (score desc, slot asc) ties,
so both packages score a corpus bit for bit alike.
"""

from __future__ import annotations

import re
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

_TOKEN = re.compile(r"[a-z0-9]+")

K1 = 1.2
B = 0.75


def tokenize(text: str) -> List[str]:
    return _TOKEN.findall(text.lower())


class BM25Index:
    """Add/Delete/Search (reference: lexical.Index iface, index.go:10)."""

    def __init__(self, k1: float = K1, b: float = B):
        self.k1 = k1
        self.b = b
        self._lock = threading.Lock()
        self._doc_slot: Dict[int, int] = {}  # external id -> slot
        self._slot_id: List[int] = []  # slot -> external id
        self._doc_len: List[int] = []
        self._alive: List[bool] = []
        # term -> (list of slots, list of tfs)
        self._postings: Dict[str, Tuple[List[int], List[int]]] = {}
        self._doc_terms: Dict[int, List[str]] = {}  # for O(terms) delete
        self._total_len = 0

    def __len__(self):
        return sum(self._alive)

    def add(self, id: int, text: str) -> None:
        toks = tokenize(text)
        with self._lock:
            if id in self._doc_slot:
                self._delete_locked(id)
            slot = len(self._slot_id)
            self._slot_id.append(id)
            self._doc_slot[id] = slot
            self._doc_len.append(len(toks))
            self._alive.append(True)
            self._total_len += len(toks)
            tf: Dict[str, int] = {}
            for t in toks:
                tf[t] = tf.get(t, 0) + 1
            for t, c in tf.items():
                slots, tfs = self._postings.setdefault(t, ([], []))
                slots.append(slot)
                tfs.append(c)
            self._doc_terms[id] = list(tf.keys())

    def delete(self, id: int) -> bool:
        with self._lock:
            return self._delete_locked(id)

    def _delete_locked(self, id: int) -> bool:
        slot = self._doc_slot.pop(id, None)
        if slot is None:
            return False
        self._alive[slot] = False
        self._total_len -= self._doc_len[slot]
        self._doc_terms.pop(id, None)
        return True

    def search_batch(
        self, queries: List[str], k: int = 10
    ) -> List[List[Tuple[int, float]]]:
        """Batched BM25 (reference fans BatchSearch out per goroutine;
        engine.go:1303): here each unique term's posting weights are computed
        ONCE for the whole batch, then accumulate into a [chunk, n_docs]
        score matrix — vectorized TAAT across queries. Returns per-query
        [(id, score)] best-first, identical to per-query `search`."""
        tok_sets = [set(tokenize(q)) for q in queries]
        with self._lock:
            n_docs = sum(self._alive)
            n_slots = len(self._slot_id)
            if n_docs == 0 or n_slots == 0:
                return [[] for _ in queries]
            avg_len = self._total_len / n_docs
            doc_len = np.asarray(self._doc_len, np.float32)
            alive = np.asarray(self._alive, bool)
            # Per-term (live slots, BM25 weights): query-independent, shared
            # by every query in the batch that contains the term. f64 weights
            # + sorted-term accumulation order => bit-identical scores to the
            # single-query path.
            term_w: Dict[str, Optional[Tuple[np.ndarray, np.ndarray]]] = {}
            for ts in tok_sets:
                for t in ts:
                    if t in term_w:
                        continue
                    p = self._postings.get(t)
                    if p is None:
                        term_w[t] = None
                        continue
                    slots = np.asarray(p[0], np.int64)
                    tfs = np.asarray(p[1], np.float32)
                    live = alive[slots]
                    slots, tfs = slots[live], tfs[live]
                    if len(slots) == 0:
                        term_w[t] = None
                        continue
                    df = len(slots)
                    idf = np.log(1.0 + (n_docs - df + 0.5) / (df + 0.5))
                    denom = tfs + self.k1 * (
                        1.0
                        - self.b
                        + self.b * doc_len[slots] / max(avg_len, 1e-9)
                    )
                    term_w[t] = (
                        slots,
                        (idf * tfs * (self.k1 + 1.0) / denom).astype(
                            np.float64
                        ),
                    )
            out: List[List[Tuple[int, float]]] = []
            # Chunk so the dense [chunk, n_slots] f64 matrix stays ~128 MB.
            chunk = max(1, int(16e6 // n_slots))
            kk = min(k, n_slots)
            for s0 in range(0, len(tok_sets), chunk):
                ts_chunk = tok_sets[s0 : s0 + chunk]
                scores = np.zeros((len(ts_chunk), n_slots), np.float64)
                inv: Dict[str, List[int]] = {}
                for r, ts in enumerate(ts_chunk):
                    for t in ts:
                        if term_w.get(t) is not None:
                            inv.setdefault(t, []).append(r)
                for t in sorted(inv):  # canonical order: matches `search`
                    rows = inv[t]
                    slots, w = term_w[t]
                    if len(rows) == 1:
                        scores[rows[0], slots] += w
                    else:
                        scores[np.ix_(np.asarray(rows), slots)] += w[None, :]
                # Selection must order EXACTLY like the single-query path
                # (score desc, slot asc, stable). argpartition alone breaks
                # ties arbitrarily, so: take the kk-th score as a threshold,
                # gather every >=-threshold candidate, lexsort those.
                kth = -np.partition(-scores, kk - 1, axis=1)[:, kk - 1]
                thr = np.where(kth > 0, kth, np.finfo(np.float64).tiny)
                rr, cc = np.nonzero(scores >= thr[:, None])
                starts = np.searchsorted(rr, np.arange(len(ts_chunk) + 1))
                for r in range(len(ts_chunk)):
                    cand = cc[starts[r] : starts[r + 1]]
                    sc = scores[r, cand]
                    o = np.lexsort((cand, -sc))[:kk]
                    out.append(
                        [
                            (self._slot_id[int(cand[j])], float(sc[j]))
                            for j in o
                            if sc[j] > 0
                        ]
                    )
            return out

    def search(self, query: str, k: int = 10) -> List[Tuple[int, float]]:
        """Returns [(id, score)] best-first."""
        toks = set(tokenize(query))
        with self._lock:
            n_docs = sum(self._alive)
            if n_docs == 0 or not toks:
                return []
            avg_len = self._total_len / n_docs
            doc_len = np.asarray(self._doc_len, np.float32)
            alive = np.asarray(self._alive, bool)
            # f64 accumulation in sorted-term order: bit-identical to
            # search_batch (ties then resolve the same way in both).
            scores = np.zeros(len(self._slot_id), np.float64)
            for t in sorted(toks):
                p = self._postings.get(t)
                if p is None:
                    continue
                slots = np.asarray(p[0], np.int64)
                tfs = np.asarray(p[1], np.float32)
                live = alive[slots]
                slots, tfs = slots[live], tfs[live]
                df = len(slots)
                if df == 0:
                    continue
                idf = np.log(1.0 + (n_docs - df + 0.5) / (df + 0.5))
                denom = tfs + self.k1 * (
                    1.0 - self.b + self.b * doc_len[slots] / max(avg_len, 1e-9)
                )
                scores[slots] += (
                    idf * tfs * (self.k1 + 1.0) / denom
                ).astype(np.float64)
            scores[~alive] = 0.0
            top = np.argsort(-scores, kind="stable")[:k]
            return [
                (self._slot_id[s], float(scores[s])) for s in top if scores[s] > 0
            ]
