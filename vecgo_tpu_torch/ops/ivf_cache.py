"""Cluster-granular device cache: coded serving beyond the device budget
(port of vecgo_tpu/ops/ivf_cache.py).

A graph segment whose coded table does not fit the device budget keeps the
full SQ8-residual table below the device: in host memory (`MemHostTable`:
encoded at open, or views of persisted `ivfq.*` sections) or in the store
itself (`LazyHostTable`: cluster blocks by ranged reads, so a segment in a
remote store serves without downloading its vectors or its code table). The
device holds all K centroids for probe selection and a fixed cache of C
cluster blocks (C*S*(d+8) bytes plus each block's centroid and scale),
filled by LRU on probe misses.

Per batch: the probes are selected on the device against every centroid;
the missing clusters are admitted with one host-to-device copy of one pinned
staging buffer and an in-place `index_copy_` into the cache tensors (PQ
transport blocks are decoded to the SQ8 layout there); probes are remapped
to cache slots (a probe that did not fit becomes the dump id C and is
dropped); and `ops/ivf.scan_groups` scans the cache with kernel B
(`coded_group_scan`): the cache tensors have the coded table's layout, so the
kernel runs on them unchanged. Winners are reranked exactly on the host by
the caller (`VamanaSegment.rerank_host`), as on the other beyond-device
paths. The JAX package scans its cache with XLA; the port's use of kernel B
here is its own choice.

Hit economics: clustered query traffic concentrates probes, so the
steady-state upload follows the probe set's churn, not the corpus; uniform
probes over a cold cache upload about one byte a dimension a row per batch,
what the streamed scan pays every batch.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from vecgo_tpu_torch.ops import ivf as ivf_ops
from vecgo_tpu_torch.ops import topk as T
from vecgo_tpu_torch.utils.tensors import host_tensor


def cache_slots(k: int, cache_clusters: int = 256, group: int = 8) -> int:
    """The cache's C for a K-cluster table: the JAX cache's size, at least a
    group, at most the table rounded to whole groups, in whole groups of
    `group` clusters."""
    c = int(min(max(group, cache_clusters), ((k + group - 1) // group) * group))
    return ((c + group - 1) // group) * group


def wanted_clusters(probes: np.ndarray, cnorm2: np.ndarray, k: int) -> np.ndarray:
    """The clusters a probe matrix [B, P] wants, each once, in probe-rank
    order (rank-0 probes matter most under cache pressure), empty clusters
    (+inf cnorm2) and the skip id K never."""
    flat = probes.T.reshape(-1)
    _, first = np.unique(flat, return_index=True)
    wanted = flat[np.sort(first)]
    wanted = wanted[wanted < k]
    return wanted[np.isfinite(cnorm2[wanted])]


def _chunk_means(v: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Member means of a chunk of clusters: v [c, S, d] (0 at empty slots)."""
    cnt = valid.sum(axis=1).astype(np.float32)
    return v.sum(axis=1) / np.maximum(cnt, 1.0)[:, None]


def host_centroids(members: np.ndarray, x: np.ndarray, chunk: int = 64):
    """The centroids `_encode_host` computes (member means) and their squared
    norms (+inf for an empty cluster, which probing never selects), without
    the encode: what a segment probes with before its cache is built."""
    k = members.shape[0]
    cent = np.zeros((k, x.shape[1]), np.float32)
    for c0 in range(0, k, chunk):
        m = members[c0 : c0 + chunk]
        valid = m >= 0
        v = x[np.maximum(m, 0)].astype(np.float32)
        v[~valid] = 0.0
        cent[c0 : c0 + chunk] = _chunk_means(v, valid)
    cn = np.einsum("kd,kd->k", cent, cent).astype(np.float32)
    cn[(members >= 0).sum(axis=1) == 0] = np.inf
    return cent, cn


def _encode_host(
    members: np.ndarray,  # [K, S] int32, -1 padded
    x: np.ndarray,  # [N, d] f32 host vectors
    chunk: int = 64,
    cent: Optional[np.ndarray] = None,  # [K, d] host_centroids' when the caller has them
) -> dict:
    """Numpy SQ8-residual encode, chunked over clusters (the host twin of
    ops/ivf._coded_build; member means = the Lloyd update). Byte for byte the
    JAX package's."""
    k, s = members.shape
    n, d = x.shape
    codes = np.zeros((k, s, d), np.int8)
    bn = np.full((k, s), np.inf, np.float32)
    xn = np.full((k, s), np.inf, np.float32)
    scale = np.zeros(k, np.float32)
    means, cent = cent, np.zeros((k, d), np.float32)
    for c0 in range(0, k, chunk):
        c1 = min(c0 + chunk, k)
        m = members[c0:c1]
        valid = m >= 0
        v = x[np.maximum(m, 0)].astype(np.float32)
        v[~valid] = 0.0
        ce = _chunk_means(v, valid) if means is None else means[c0:c1]
        res = np.where(valid[:, :, None], v - ce[:, None, :], 0.0)
        sc = np.maximum(np.abs(res).max(axis=(1, 2)) / 127.0, 1e-12)
        cd = np.clip(np.round(res / sc[:, None, None]), -127, 127).astype(np.int8)
        rh = cd.astype(np.float32) * sc[:, None, None]
        codes[c0:c1] = cd
        bn[c0:c1] = np.where(valid, np.einsum("ksd,ksd->ks", rh, rh), np.inf)
        xh = ce[:, None, :] + rh
        xn[c0:c1] = np.where(valid, np.einsum("ksd,ksd->ks", xh, xh), np.inf)
        scale[c0:c1] = sc
        cent[c0:c1] = ce
    cn = np.einsum("kd,kd->k", cent, cent).astype(np.float32)
    empty = (members >= 0).sum(axis=1) == 0
    cn[empty] = np.inf  # probing never selects empty clusters
    return {
        "codes": codes,
        "bn": bn,
        "xn": xn,
        "rows": np.ascontiguousarray(members, dtype=np.int32),
        "scale": scale,
        "cent": cent,
        "cnorm2": cn,
    }


def _encode_host_pq(
    members: np.ndarray,  # [K, S] int32, -1 padded
    x: np.ndarray,  # [N, d] f32 host vectors
    kind: str = "pq",  # "pq" | "opq" (learned rotation before PQ)
    m: int = 0,  # subspaces; 0 = d//4 (4x fewer bytes than SQ8)
    seed: int = 42,
    sample: int = 65536,
    chunk: int = 64,
    device="cpu",  # where the codebooks train and the residuals are assigned
) -> dict:
    """PQ-residual transport encode: cluster blocks ship as m bytes a slot
    (against d for SQ8) and are decoded and requantized to the SQ8 cache
    layout on the device at admission. bn and scale describe the final
    double-quantized form (scale * round(decode(pq(res)) / scale)), so the
    device scores are self-consistent. The codebooks come from the port's own
    k-means, so they differ from the JAX package's after training."""
    from vecgo_tpu_torch.quantization.pq import OPQQuantizer, PQQuantizer

    k, s = members.shape
    n, d = x.shape
    m = int(m) if m else max(1, d // 4)
    # Pass 1: per-cluster means + a residual sample for codebook training.
    cent = np.zeros((k, d), np.float32)
    rng = np.random.default_rng(seed)
    samples = []
    per_chunk = max(256, sample // max(1, k // chunk))
    for c0 in range(0, k, chunk):
        c1 = min(c0 + chunk, k)
        mem = members[c0:c1]
        valid = mem >= 0
        v = x[np.maximum(mem, 0)].astype(np.float32)
        v[~valid] = 0.0
        cnt = valid.sum(axis=1).astype(np.float32)
        ce = v.sum(axis=1) / np.maximum(cnt, 1.0)[:, None]
        cent[c0:c1] = ce
        res = (v - ce[:, None, :]).reshape(-1, d)[valid.reshape(-1)]
        if len(res):
            take = min(len(res), per_chunk)
            samples.append(res[rng.choice(len(res), take, replace=False)])
    res_sample = np.concatenate(samples) if samples else np.zeros((1, d), np.float32)
    if len(res_sample) > sample:
        res_sample = res_sample[rng.choice(len(res_sample), sample, replace=False)]
    q = (OPQQuantizer if kind == "opq" else PQQuantizer)(d, m=m, device=device)
    q.train(res_sample, seed=seed)
    rot = getattr(q, "rotation", None)
    pq = q.pq if kind == "opq" else q

    # Pass 2: encode every slot's residual; stats over the decoded form.
    codes = np.zeros((k, s, m), np.uint8)
    bn = np.full((k, s), np.inf, np.float32)
    scale = np.zeros(k, np.float32)
    for c0 in range(0, k, chunk):
        c1 = min(c0 + chunk, k)
        mem = members[c0:c1]
        valid = mem >= 0
        v = x[np.maximum(mem, 0)].astype(np.float32)
        v[~valid] = 0.0
        res = np.where(valid[:, :, None], v - cent[c0:c1, None, :], 0.0)
        flat = res.reshape(-1, d)
        if rot is not None:
            flat = flat @ rot
        cd_pq = pq._assign(flat)
        dec = pq._decode_codes(cd_pq)
        if rot is not None:
            dec = dec @ rot.T
        dec = dec.reshape(c1 - c0, s, d)
        dec[~valid] = 0.0
        sc = np.maximum(np.abs(dec).max(axis=(1, 2)) / 127.0, 1e-12)
        cd = np.clip(np.round(dec / sc[:, None, None]), -127, 127).astype(np.int8)
        rh = cd.astype(np.float32) * sc[:, None, None]
        codes[c0:c1] = cd_pq.reshape(c1 - c0, s, m)
        bn[c0:c1] = np.where(valid, np.einsum("ksd,ksd->ks", rh, rh), np.inf)
        scale[c0:c1] = sc
    cn = np.einsum("kd,kd->k", cent, cent).astype(np.float32)
    cn[(members >= 0).sum(axis=1) == 0] = np.inf
    return {
        "pq": codes,
        "cb": np.asarray(pq.codebooks, np.float32),
        "rot": None if rot is None else np.asarray(rot, np.float32),
        "bn": bn,
        "rows": np.ascontiguousarray(members, dtype=np.int32),
        "scale": scale,
        "cent": cent,
        "cnorm2": cn,
    }


class MemHostTable:
    """In-memory host side of the cluster cache: the full coded table as
    numpy arrays (encoded at open by `_encode_host`, or views of persisted
    `ivfq.*` container sections)."""

    def __init__(self, h: dict):
        self.rows = h["rows"]
        self.cent = h["cent"]
        self.cnorm2 = h["cnorm2"]
        self.scale = h["scale"]
        # Transport form: dense int8 rows ("sq8") or PQ codes ("pq"/"opq":
        # m bytes a slot, decoded on the device at admission).
        self.kind = "pq" if "pq" in h else "sq8"
        self.cb = h.get("cb")
        self.rot = h.get("rot")
        self._codes = h["pq"] if self.kind == "pq" else h["codes"]
        self._bn = h["bn"]

    def fetch(self, idx: np.ndarray):
        """(codes [m, S, d] int8 | pq [m, S, M] uint8, bn [m, S] f32) of
        clusters `idx`."""
        return self._codes[idx], self._bn[idx]


class LazyHostTable:
    """Store-backed host side: cluster blocks come from ranged reads of the
    persisted `ivfq.*` sections. Only the small per-cluster arrays
    (centroids, norms, scales, membership) are resident; the codes stay in
    the store, and a CachingStore underneath gives the RAM and disk block
    tiers. A miss batch reads O(fetched clusters) bytes, whatever N is."""

    def __init__(self, lazy, members: np.ndarray):
        self.lazy = lazy
        self.rows = np.ascontiguousarray(members, np.int32)
        self.cent = np.asarray(lazy.load("ivfq.cent"), np.float32)
        self.cnorm2 = np.asarray(lazy.load("ivfq.cnorm2"), np.float32)
        self.scale = np.asarray(lazy.load("ivfq.scale"), np.float32)
        self.kind = "pq" if lazy.has("ivfq.pq") else "sq8"
        self._codes_sec = "ivfq.pq" if self.kind == "pq" else "ivfq.codes"
        self.cb = np.asarray(lazy.load("ivfq.cb"), np.float32) if lazy.has("ivfq.cb") else None
        self.rot = np.asarray(lazy.load("ivfq.rot"), np.float32) if lazy.has("ivfq.rot") else None
        self.store_bytes = 0
        # Compressed sections cannot be sliced by offset: load them once and
        # serve from memory (right, but without the per-block reads; store
        # codes uncompressed for a remote tier).
        self._mem = None
        if any(lazy.entries.get(s, {}).get("compression") for s in (self._codes_sec, "ivfq.bn")):
            self._mem = (lazy.load(self._codes_sec), lazy.load("ivfq.bn"))

    def fetch(self, idx: np.ndarray):
        if self._mem is not None:
            return self._mem[0][idx], self._mem[1][idx]
        k = len(idx)
        codes = [None] * k
        bn = [None] * k
        # Ascending runs of consecutive clusters coalesce into one ranged
        # read each.
        order = np.argsort(idx, kind="stable")
        i = 0
        while i < k:
            j = i
            while j + 1 < k and idx[order[j + 1]] == idx[order[j]] + 1:
                j += 1
            c0, c1 = int(idx[order[i]]), int(idx[order[j]]) + 1
            cblk = self.lazy.load_rows(self._codes_sec, c0, c1)
            bblk = self.lazy.load_rows("ivfq.bn", c0, c1)
            self.store_bytes += cblk.nbytes + bblk.nbytes
            for t in range(i, j + 1):
                codes[order[t]] = cblk[idx[order[t]] - c0]
                bn[order[t]] = bblk[idx[order[t]] - c0]
            i = j + 1
        return np.stack(codes), np.stack(bn)


class CacheTable(NamedTuple):
    """The cache tensors in the layout `ops/ivf.scan_groups` scans."""

    codes: torch.Tensor  # [C, S, d] int8
    scale: torch.Tensor  # [C] f32
    bnorm2: torch.Tensor  # [C, S] f32, +inf at empty slots
    rows: torch.Tensor  # [C, S] int32 segment rows, -1 empty
    centroids: torch.Tensor  # [C, d] f32


def _probe(q: torch.Tensor, cent: torch.Tensor, cnorm2: torch.Tensor, n_probe: int):
    """The n_probe nearest centroids of every query [B, n_probe] (int64):
    |q|^2 + |c|^2 - 2 q.c with the product over bf16-rounded operands in f32
    (the JAX probe's bf16 product), ties to the lower cluster."""
    qf = q.float()
    cd = (qf * qf).sum(-1)[:, None] + cnorm2[None, :] - 2.0 * (
        qf.to(torch.bfloat16).float() @ cent.to(torch.bfloat16).float().T)
    return T.topk_smallest(cd, n_probe)[1]


def _decode_pq(pqb: torch.Tensor, cb: torch.Tensor, rot: Optional[torch.Tensor],
               rows: torch.Tensor, scale: torch.Tensor, d: int) -> torch.Tensor:
    """Admission-time PQ decode: blocks [m, S, M] of PQ codes to the dense
    int8 layout of the cache, round(decode / scale) clipped to +-127. The
    codebook select is exact, so without a rotation this reproduces the
    host decode that bn and scale were computed from; OPQ's un-rotation is
    an f32 product."""
    mp, s, mm = pqb.shape
    sub = torch.arange(mm, device=pqb.device)
    dec = cb[sub[None, None, :], pqb.long()]  # [m, S, M, dsub]
    dec = dec.reshape(mp, s, -1)[..., :d]
    if rot is not None:
        dec = dec @ rot.T
    dec = torch.where((rows >= 0)[..., None], dec, 0.0)
    return torch.round(dec / scale[:, None, None]).clamp(-127, 127).to(torch.int8)


class ClusterCachedTable:
    """Fixed-size coded serving table for graph segments beyond the device
    budget.

    device_bytes() = C*(S*(d+8) + d*4 + 4) + K*(d*4 + 4): independent of N.
    `probe_and_scan` has the results contract of ops/ivf.ivf_scan (distances
    to the decoded rows; segment rows; -1 invalid), minus the probes dropped
    when a batch's unique probe set is larger than the cache (counted in
    stats["dropped_probes"])."""

    def __init__(
        self,
        members: np.ndarray = None,  # [K, S] int32 (-1 padded), e.g. seg.ivf_members
        vectors: np.ndarray = None,  # [N, d] f32 host vectors (encode at open)
        cache_clusters: int = 256,
        group: int = 8,
        host=None,  # MemHostTable | LazyHostTable (persisted codes)
        device="cuda",
    ):
        if host is None:
            host = MemHostTable(_encode_host(np.asarray(members), np.asarray(vectors, np.float32)))
        self.host = host
        k, s = host.rows.shape
        self.k, self.s, self.d = k, s, host.cent.shape[1]
        self.c = c = cache_slots(k, cache_clusters, group)
        self.group = group
        self.cent_dev = host_tensor(host.cent).to(device, torch.float32)
        self.device = dev = self.cent_dev.device  # "cuda" resolved to its index
        self.cnorm2_dev = host_tensor(host.cnorm2).to(dev, torch.float32)
        # The cache, slot-major. bn = +inf marks an empty slot: a probe that
        # reaches an unfilled slot scores nothing.
        self.codes_c = torch.zeros((c, s, self.d), dtype=torch.int8, device=dev)
        self.bn_c = torch.full((c, s), math.inf, dtype=torch.float32, device=dev)
        self.rows_c = torch.full((c, s), -1, dtype=torch.int32, device=dev)
        self.scale_c = torch.ones(c, dtype=torch.float32, device=dev)
        self.cent_c = torch.zeros((c, self.d), dtype=torch.float32, device=dev)
        self._lru: "OrderedDict[int, int]" = OrderedDict()  # cluster -> slot
        self._free = list(range(c))[::-1]
        self._cb_dev = self._rot_dev = None
        if host.kind == "pq":
            self._cb_dev = host_tensor(host.cb).to(dev, torch.float32)
            if host.rot is not None:
                self._rot_dev = host_tensor(host.rot).to(dev, torch.float32)
        # One pinned staging buffer for the admissions' upload, reused once
        # the copy that last read it has finished.
        self._staging = None
        self._staged = None
        self.stats = {"hits": 0, "misses": 0, "h2d_bytes": 0, "dropped_probes": 0, "batches": 0}

    def device_bytes(self) -> int:
        return int(self.c * (self.s * (self.d + 4 + 4) + self.d * 4 + 4)
                   + self.k * (self.d * 4 + 4))

    # ------------------------------------------------------------------
    def _ensure_cached(self, wanted: np.ndarray) -> dict:
        """LRU-admit `wanted` clusters (probe-rank order); returns cluster ->
        slot for everything now resident."""
        missing = [int(cl) for cl in wanted if cl not in self._lru]
        for cl in wanted:
            cl = int(cl)
            if cl in self._lru:
                self._lru.move_to_end(cl)
        n_admit = min(len(missing), self.c)
        if n_admit < len(missing):
            self.stats["dropped_probes"] += len(missing) - n_admit
            missing = missing[:n_admit]
        self.stats["hits"] += len(wanted) - len(missing)
        self.stats["misses"] += len(missing)
        if missing:
            wanted_set = set(int(x) for x in wanted)
            slots = []
            for cl in missing:
                if self._free:
                    slot = self._free.pop()
                else:
                    # Evict the least recently used cluster this batch does
                    # not want.
                    victim = None
                    for cand in self._lru:
                        if cand not in wanted_set:
                            victim = cand
                            break
                    if victim is None:  # the whole cache is wanted: drop instead
                        self.stats["dropped_probes"] += 1
                        continue
                    slot = self._lru.pop(victim)
                slots.append(slot)
                self._lru[cl] = slot
                self._lru.move_to_end(cl)
            if slots:
                self._admit(np.asarray(missing[: len(slots)], np.int64), slots)
        return self._lru

    def _admit(self, idx: np.ndarray, slots) -> None:
        """Write clusters idx into cache slots: the blocks (host RAM or the
        store's ranged reads) and their rows, scales and centroids are packed
        into one pinned buffer, uploaded with one copy, and written into the
        cache tensors in place (`index_copy_`)."""
        h = self.host
        codes_b, bn_b = h.fetch(idx)
        parts = [np.ascontiguousarray(codes_b), np.ascontiguousarray(bn_b, np.float32),
                 np.ascontiguousarray(h.rows[idx], np.int32),
                 np.ascontiguousarray(h.scale[idx], np.float32),
                 np.ascontiguousarray(h.cent[idx], np.float32)]
        offs, total = [], 0
        for a in parts:
            offs.append(total)
            total += -(-a.nbytes // 16) * 16  # 16-byte aligned views
        dev = self.device
        if dev.type == "cuda":
            if self._staging is None or self._staging.numel() < total:
                self._staging = torch.empty(total, dtype=torch.uint8, pin_memory=True)
            elif self._staged is not None:
                self._staged.synchronize()  # the last upload has read the buffer
            stage = self._staging[:total]
        else:
            stage = torch.empty(total, dtype=torch.uint8)
        for a, o in zip(parts, offs):
            stage[o : o + a.nbytes].numpy()[:] = a.reshape(-1).view(np.uint8)
        buf = stage.to(dev, non_blocking=True)
        if dev.type == "cuda":
            self._staged = torch.cuda.Event()
            self._staged.record(torch.cuda.current_stream(dev))
        self.stats["h2d_bytes"] += int(sum(a.nbytes for a in parts))

        def view(i, dtype):
            a = parts[i]
            return buf[offs[i] : offs[i] + a.nbytes].view(dtype).view(a.shape)

        m = len(idx)
        slots_t = torch.as_tensor(slots, dtype=torch.int64).to(dev, non_blocking=True)
        rows_b, scale_b = view(2, torch.int32), view(3, torch.float32)
        if h.kind == "pq":
            codes_t = _decode_pq(view(0, torch.uint8), self._cb_dev, self._rot_dev, rows_b,
                                 scale_b, self.d)
        else:
            codes_t = view(0, torch.int8)
        self.codes_c.index_copy_(0, slots_t, codes_t.reshape(m, self.s, self.d))
        self.bn_c.index_copy_(0, slots_t, view(1, torch.float32))
        self.rows_c.index_copy_(0, slots_t, rows_b)
        self.scale_c.index_copy_(0, slots_t, scale_b)
        self.cent_c.index_copy_(0, slots_t, view(4, torch.float32))

    def table(self) -> CacheTable:
        return CacheTable(self.codes_c, self.scale_c, self.bn_c, self.rows_c, self.cent_c)

    def probe(self, qd: torch.Tensor, n_probe: int) -> np.ndarray:
        """The batch's probes: qd [B, d] f32 on the cache's device -> [B, P]
        cluster ids (numpy: a small D2H)."""
        return _probe(qd, self.cent_dev, self.cnorm2_dev, int(min(n_probe, self.k))).cpu().numpy()

    def _wanted(self, probes: np.ndarray) -> np.ndarray:
        """The clusters a probe matrix wants (`wanted_clusters`)."""
        return wanted_clusters(probes, self.host.cnorm2, self.k)

    def chunks(self, probes: np.ndarray) -> list:
        """The clusters that probes [B, P] want, in chunks of at most C: one
        chunk when they fit the cache, else the resident ones first (in LRU
        order), then the rest in probe-rank order. Scanning each chunk's
        (query, probe) pairs in turn admits every cluster once and drops no
        probe."""
        wanted = self._wanted(probes)
        if len(wanted) <= self.c:
            return [wanted]
        want = set(wanted.tolist())
        resident = np.asarray([cl for cl in self._lru if cl in want], np.int64)
        order = np.concatenate([resident, wanted[~np.isin(wanted, resident)]])
        return [order[i : i + self.c] for i in range(0, len(order), self.c)]

    def probe_slots(self, qd: torch.Tensor, n_probe: int, qcap: int = 0,
                    probes: Optional[np.ndarray] = None):
        """Probe, admit the misses and remap: qd [B, d] f32 on the cache's
        device -> (probes [B, P] int64 cache slots on that device, a probe
        left out being the dump id C; qcap, sized to the batch's peak
        per-slot load when 0; cluster -> slot of everything resident).
        probes: the batch's [B, P] cluster ids when the caller has them (K
        skips a probe)."""
        if probes is None:
            probes = self.probe(qd, n_probe)
        wanted = self._wanted(probes)
        slot_of = self._ensure_cached(wanted.astype(np.int64))
        lut = np.full(self.k + 1, self.c, np.int64)
        for cl, slot in slot_of.items():
            lut[cl] = slot
        probes_m = lut[probes]
        if qcap == 0:
            # Exact no-drop capacity: size qcap to the peak per-cluster load
            # of this batch (the probe matrix is on the host already).
            cnt = np.bincount(probes_m.ravel(), minlength=self.c + 1)[: self.c]
            peak = int(cnt.max()) if cnt.size else 1
            qcap = max(32, (peak + 31) // 32 * 32)
        return torch.from_numpy(probes_m).to(self.device), min(qcap, qd.shape[0]), slot_of

    def probe_and_scan(
        self,
        q,  # [B, d] tensor (on the cache's device) or numpy
        n_probe: int,
        kk: int,
        qcap: int = 0,
        row_mask: Optional[np.ndarray] = None,  # [N] bool host mask
        probes: Optional[np.ndarray] = None,  # [B, P] cluster ids, K skips
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The first stage of the two-stage search with a fixed device
        footprint. Returns (dists [B, P*kk] f32, seg_rows [B, P*kk] int64,
        -1 invalid) on the cache's device."""
        self.stats["batches"] += 1
        qd = q if isinstance(q, torch.Tensor) else torch.from_numpy(np.asarray(q, np.float32))
        qd = qd.to(self.device, torch.float32).contiguous()
        probes_m, qcap, slot_of = self.probe_slots(qd, n_probe, qcap, probes)
        mask_flat = None
        if row_mask is not None:
            # The [N] row mask lifted into the cached slot space on the host
            # (the cache is small; a [C, S] bool upload a batch is cheap).
            order = np.asarray(list(slot_of.items()), np.int64)
            mk = np.zeros((self.c, self.s), bool)
            if len(order):
                cls, sls = order[:, 0], order[:, 1]
                rr = self.host.rows[cls]
                mk[sls] = np.asarray(row_mask)[np.maximum(rr, 0)] & (rr >= 0)
            mask_flat = torch.from_numpy(mk).to(self.device)
        return ivf_ops.scan_groups(qd, self.table(), probes_m, mask_flat, kk=kk, qcap=qcap)


__all__ = ["CacheTable", "ClusterCachedTable", "LazyHostTable", "MemHostTable"]
