"""Carry state from the JAX package into the port.

Both packages write the same container and manifest formats, so a database
directory moves between them simply by opening it with the other package.
`segment_from_jax` moves one in-memory JAX `FlatSegment` without a store, with
its codes and its quantizer's trained arrays, `quantizer_from_jax` moves a
trained quantizer, and `host_table_from_jax` moves the host side of a cluster
cache (its coded table), so both packages score the same codes with the same
arrays. `ivf_table_from_jax` moves a device IVF table (bf16 residual blocks
or SQ8 codes), `vamana_segment_from_arrays` makes a port VamanaSegment from
a graph and membership another build made (the JAX package's beam build or
`build_ivf_table`), so that a search parity does not rest on two builds'
random draws, and `fresh_from_jax` moves a JAX FreshVamana's state.
`bm25_from_jax` moves a JAX BM25Index's postings, slots, lengths and
liveness, and `device_bm25_from_jax` a JAX DeviceBM25 snapshot with its hot
vocabulary and bf16 table.
"""

from __future__ import annotations

import numpy as np
import torch

from vecgo_tpu_torch import quantization as Q
from vecgo_tpu_torch.index import common
from vecgo_tpu_torch.index.flat import FlatSegment, segment_stats
from vecgo_tpu_torch.model import Metric
from vecgo_tpu_torch.ops import ivf as ivf_ops
from vecgo_tpu_torch.ops.ivf_cache import MemHostTable


def quantizer_from_jax(quant, device=None) -> Q.Quantizer:
    """The port's quantizer from a JAX quantizer's `state()` (its kind, its
    constructor params and its trained arrays, as numpy). `device` is where
    PQ and OPQ assign in `encode` (None = the card)."""
    state = quant.state()
    arrays = {name: np.asarray(arr) for name, arr in state["arrays"].items() if arr is not None}
    return Q.Quantizer.from_state(
        {"kind": state["kind"], "params": state["params"], "arrays": arrays}, device=device)


def segment_from_jax(seg, device) -> FlatSegment:
    """The port's FlatSegment over a JAX FlatSegment's host arrays (shared,
    not copied), with its device state built on `device`."""
    seg._ensure_blob("docs")
    seg._ensure_blob("payload")
    sections = {"ids": seg.ids, "vectors": seg.vectors, "rnorm2": seg.rnorm2, "lsns": seg.lsns}
    sections.update(seg.cm.to_sections()[1])
    for prefix in ("docs", "payload"):
        data = getattr(seg, f"_{prefix}_data")
        if data is not None:
            sections[f"{prefix}.data"] = data
            sections[f"{prefix}.indptr"] = getattr(seg, f"_{prefix}_indptr")
    for name in ("ivf.centroids", "ivf.part"):
        arr = getattr(seg, name.replace(".", "_"))
        if arr is not None:
            sections[name] = arr
    if seg.quant.kind != "none":
        for name, arr in seg.enc_host.items():
            sections[f"enc.{name}"] = np.asarray(arr)
        for name, arr in seg.quant.state()["arrays"].items():
            if arr is not None:
                sections[f"q.{name}"] = np.asarray(arr)
    out = FlatSegment(seg.meta, sections, seg.seg_id)
    out.device_state(device)
    return out


def host_table_from_jax(h: dict) -> MemHostTable:
    """The port's MemHostTable over a JAX host table: the dict that
    `vecgo_tpu.ops.ivf_cache._encode_host` returns (codes, bn, xn, rows,
    scale, cent, cnorm2) or `_encode_host_pq` returns (pq, cb, rot, bn, rows,
    scale, cent, cnorm2). PQ codebooks differ between the packages after
    training, so holding both caches to the same codes takes this."""
    return MemHostTable({name: None if arr is None else np.asarray(arr)
                         for name, arr in h.items()})


def ivf_table_from_jax(table, device):
    """The port's IVFDeviceTable or IVFCodedTable over a JAX table's arrays
    (vecgo_tpu.ops.ivf), on `device`; bf16 blocks stay bf16."""
    def t(arr):
        if arr is None:
            return None
        a = np.asarray(arr)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
        return torch.from_numpy(np.array(a)).to(device)

    cls = ivf_ops.IVFCodedTable if hasattr(table, "codes") else ivf_ops.IVFDeviceTable
    return cls(**{name: t(getattr(table, name)) for name in cls._fields})


def vamana_segment_from_arrays(x: np.ndarray, graph: np.ndarray, medoid: int,
                               entry_centroids: np.ndarray, entry_nodes: np.ndarray,
                               members=None, metric: Metric = Metric.L2, r: int = 0,
                               seg_id: int = 0):
    """A port VamanaSegment over rows x [N, d] (ids 0..N-1) with a graph and
    IVF membership built elsewhere: the sections and meta `VamanaWriter`
    writes, without a build."""
    from vecgo_tpu_torch.index.vamana import SEGMENT_KIND, VamanaSegment

    x = np.ascontiguousarray(x, np.float32)
    n, d = x.shape
    sections, md_meta, cm = common.row_sections(x, np.arange(n, dtype=np.int64), [None] * n,
                                                [None] * n)
    sections["graph"] = np.ascontiguousarray(graph, np.int32)
    sections["entry.centroids"] = np.asarray(entry_centroids, np.float32)
    sections["entry.nodes"] = np.asarray(entry_nodes, np.int32)
    ivf_meta = None
    if members is not None:
        sections["ivf.members"] = np.ascontiguousarray(members, np.int32)
        ivf_meta = {"capacity": int(members.shape[1]), "k": int(members.shape[0]),
                    "coded": True}
    meta = {"kind": SEGMENT_KIND, "dim": d, "metric": Metric(metric).value, "count": n,
            "medoid": int(medoid), "r": int(r or graph.shape[1]), "l_build": 0, "alpha": 0.0,
            "quantizer": {"kind": "none", "params": {}}, "ivf": ivf_meta,
            "metadata": md_meta, "stats": segment_stats(x, cm)}
    return VamanaSegment(meta, sections, seg_id)


def fresh_from_jax(fv, device):
    """The port's FreshVamana with a JAX FreshVamana's parameters, rows,
    soft deletes, medoid and graph, on `device`."""
    from vecgo_tpu_torch.index.fresh import FreshVamana

    out = FreshVamana(fv.dim, Metric(fv.metric.value), r=fv.r, l_build=fv.l_build,
                      alpha=fv.alpha, beam_width=fv.beam_width,
                      consolidate_threshold=fv.consolidate_threshold, device=device)
    if fv.n:
        out._ensure_capacity(fv.capacity)
        out.n = fv.n
        out.x[:] = fv.x
        out.deleted[:] = fv.deleted
        out.medoid = fv.medoid
        out._set_rows_device(np.arange(fv.capacity), out.x)
        out._dev["graph"][:] = torch.from_numpy(np.array(fv._dev["graph"])).to(device)
    return out


def bm25_from_jax(index):
    """The port's BM25Index with a JAX BM25Index's parameters, postings,
    slots, document lengths and liveness (copies, not shared lists)."""
    from vecgo_tpu_torch.lexical.bm25 import BM25Index

    out = BM25Index(k1=index.k1, b=index.b)
    with index._lock:
        out._doc_slot = dict(index._doc_slot)
        out._slot_id = list(index._slot_id)
        out._doc_len = list(index._doc_len)
        out._alive = list(index._alive)
        out._postings = {t: (list(s), list(f)) for t, (s, f) in index._postings.items()}
        out._doc_terms = {i: list(ts) for i, ts in index._doc_terms.items()}
        out._total_len = index._total_len
    return out


def device_bm25_from_jax(dev, device):
    """The port's DeviceBM25 over a JAX DeviceBM25 snapshot: its index
    (through `bm25_from_jax`), its snapshot arrays, its hot vocabulary and
    its bf16 table `w_host`, read through a uint16 view (no ml_dtypes)."""
    from vecgo_tpu_torch.lexical.device_bm25 import DeviceBM25

    out = DeviceBM25(bm25_from_jax(dev.index), max_hot_terms=0,
                     pool_margin=dev.pool_margin, device=device)
    out.n_slots, out.n_docs = dev.n_slots, dev.n_docs
    out.slot_id, out.alive = dev.slot_id.copy(), dev.alive.copy()
    out.avg_len, out.doc_len = dev.avg_len, dev.doc_len.copy()
    out.hot = dict(dev.hot)
    if out.hot:
        bits = np.ascontiguousarray(dev.w_host).view(np.uint16).view(np.int16)
        out._set_table(torch.from_numpy(bits).view(torch.bfloat16))
    return out
