"""Carry state from the JAX package into the port.

Both packages write the same container and manifest formats, so a database
directory moves between them simply by opening it with the other package.
`segment_from_jax` moves one in-memory JAX `FlatSegment` without a store, with
its codes and its quantizer's trained arrays, `quantizer_from_jax` moves a
trained quantizer, and `host_table_from_jax` moves the host side of a cluster
cache (its coded table), so both packages score the same codes with the same
arrays.
"""

from __future__ import annotations

import numpy as np

from vecgo_tpu_torch import quantization as Q
from vecgo_tpu_torch.index.flat import FlatSegment
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
