"""Drives the program under test: the one module of the benchmark that
imports `vecgo_tpu_torch`.

It builds a cell's deployment from generated inputs (`open_db`), warms the
cell's shapes (`warm`), serves the timed window (`serve`) and, in traced
runs, records host spans and counters around calls into the port's layers
(`Probe`). The port itself is not changed: the probe wraps module and class
attributes for the window and puts them back afterwards. If a later change
renames a wrapped function, `Probe` skips it and the metrics that read its
span read nothing.
"""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

import vecgo_tpu_torch as vg
from vecgo_tpu_torch import metadata as vmeta
from vecgo_tpu_torch.engine import memtable as vmemtable
from vecgo_tpu_torch.engine import search as vsearch
from vecgo_tpu_torch.index import flat as vflat
from vecgo_tpu_torch.model import Metric
from vecgo_tpu_torch.ops import topk as vtopk

from benchport import gen

# (owner, attribute, span name): the layers' entries that a traced run wraps.
SPANS = (
    (vsearch, "_dispatch_batch", "planner.dispatch"),
    (vsearch, "_drain_batch", "planner.drain"),
    (vsearch, "_finish", "planner.finish"),
    (vsearch, "_merge_device", "planner.merge"),
    (vflat.FlatSegment, "search", "segment.search"),
    (vmemtable.MemTable, "search", "memtable.search"),
    (vtopk, "scan_topk", "scan_topk"),
)
_BACKENDS = {"memory": vg.Memory}


def search_kwargs(traffic: dict) -> dict:
    """The traffic's search options as the program takes them."""
    if traffic["entry"] != "search_arrays_stream":
        raise ValueError(f"only search_arrays_stream is served, not {traffic['entry']!r}")
    f = traffic.get("filter")
    if not f:
        return {}
    return {"filter": getattr(vmeta, f["op"])(f["field"], f["value"])}


def open_db(cfg: dict, inputs: gen.Inputs, device) -> tuple:
    """The deployment: every committed row bulk-loaded and committed once,
    the memtable tail inserted, then the deletes. The configuration's
    "options" are the engine's (`EngineOptions`) as the deployment sets
    them. Returns (db, commit seconds)."""
    n, m = int(cfg["rows"]), int(cfg["memtable_rows"])
    opts = vg.Create(dim=int(cfg["dim"]), metric=Metric(cfg["metric"]),
                     flush_threshold=n + 1, device=device, **cfg.get("options", {}))
    db = vg.Open(_BACKENDS[cfg["backend"]](), opts)
    db.insert_batch(inputs.base, gen.docs(inputs.meta, 0, n), ids=np.arange(n, dtype=np.int64))
    t0 = time.perf_counter()
    db.commit()
    commit_s = time.perf_counter() - t0
    if m:
        db.insert_batch(inputs.tail, gen.docs(inputs.meta, n, n + m),
                        ids=np.arange(n, n + m, dtype=np.int64))
    for i in inputs.deleted:
        if not db.delete(int(i)):
            raise RuntimeError(f"delete of id {int(i)} found no row")
    return db, commit_s


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def warm(db, traffic: dict, pool: list, device) -> None:
    """Plan, device state and kernels of the cell's own shapes: a stream as
    long as the window's first batches."""
    n = int(traffic["warm_batches"])
    batches = [pool[i % len(pool)] for i in range(n)]
    for _ in db.search_arrays_stream(iter(batches), k=int(traffic["k"]),
                                     depth=int(traffic["depth"]), **search_kwargs(traffic)):
        pass
    _sync(device)


@dataclass
class Window:
    """What the timed window served: host clock readings (perf_counter s)."""

    t0: float
    pulls: List[tuple] = field(default_factory=list)  # (time, pool index) per batch
    done: List[tuple] = field(default_factory=list)  # (time, ids, dists) per batch, in order


def serve(db, traffic: dict, pool: list, seconds: float) -> Window:
    """One caller keeps `depth` batches in flight through
    `search_arrays_stream`, cycling the pool, and stops offering batches once
    `seconds` have passed; every batch offered is completed."""
    k, depth = int(traffic["k"]), int(traffic["depth"])
    win = Window(time.perf_counter())
    t_end = win.t0 + seconds

    def source():
        i = 0
        while True:
            t = time.perf_counter()
            if t >= t_end:
                return
            win.pulls.append((t, i % len(pool)))
            yield pool[i % len(pool)]
            i += 1

    for ids, dists in db.search_arrays_stream(source(), k=k, depth=depth,
                                              **search_kwargs(traffic)):
        win.done.append((time.perf_counter(), ids, dists))
    return win


class Probe:
    """Host spans (seconds per call, by span name) and the shapes of every
    `scan_topk` call, recorded around the port's layer entries while
    installed. Each call is also a `record_function` range named
    `bp:<span>` (`bp:scan_topk@<enclosing span>` for scans), which the
    trace reader attributes device operations by."""

    def __init__(self):
        self.host = defaultdict(list)
        self.scans: List[dict] = []
        self._stack: List[str] = []
        self._saved: list = []

    def _wrap(self, fn, name):
        probe = self

        def wrapped(*args, **kwargs):
            scan = name == "scan_topk"
            ctx = next((s for s in reversed(probe._stack) if s.endswith(".search")), "")
            label = f"{name}@{ctx}" if scan and ctx else name
            probe._stack.append(name)
            t0 = time.perf_counter()
            try:
                with torch.profiler.record_function("bp:" + label):
                    return fn(*args, **kwargs)
            finally:
                probe.host[label].append(time.perf_counter() - t0)
                probe._stack.pop()
                if scan:
                    q, x, k = args[0], args[1], args[3] if len(args) > 3 else kwargs["k"]
                    mask = args[5] if len(args) > 5 else kwargs.get("mask")
                    probe.scans.append(dict(
                        span=label, b=int(q.shape[0]), n=int(x.shape[0]), d=int(q.shape[1]),
                        k=int(k), table="bf16" if x.dtype == torch.bfloat16 else "f32",
                        masked=mask is not None))

        return wrapped

    def __enter__(self):
        for owner, attr, name in SPANS:
            fn = getattr(owner, attr, None)
            if fn is None:
                continue
            self._saved.append((owner, attr, fn))
            setattr(owner, attr, self._wrap(fn, name))
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        self._saved.clear()
