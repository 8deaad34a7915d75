"""Carry state from the JAX package into the port.

Both packages write the same container and manifest formats, so a database
directory moves between them simply by opening it with the other package.
`segment_from_jax` moves one in-memory JAX `FlatSegment` without a store.
"""

from __future__ import annotations

from vecgo_tpu_torch.index.flat import FlatSegment


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
    out = FlatSegment(seg.meta, sections, seg.seg_id)
    out.device_state(device)
    return out
