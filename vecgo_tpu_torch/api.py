"""Public API of the port (mirrors vecgo_tpu/api.py).

    import vecgo_tpu_torch as vecgo

    db = vecgo.Open(vecgo.Local("/data/db"), vecgo.Create(dim=128))
    ids = db.insert_batch(vectors)
    db.commit()
    ids, dists = db.search_arrays(queries, k=10)

Backends: Local(dir) / Remote(store) / Memory(). Remote(read_only=True) gives
the stateless read-replica mode: many readers over one shared store, single
writer via manifest CAS. `Create` and `Open` build the port's engine, whose
scans run on `device` ("cuda" by default, "cpu" for the plain PyTorch path).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Optional

from vecgo_tpu_torch.blobstore import BlobStore, MemoryStore
from vecgo_tpu_torch.engine import Engine, EngineOptions
from vecgo_tpu_torch.model import Metric

__all__ = ["Backend", "Create", "DB", "Local", "Memory", "Open", "Remote"]


@dataclass
class Backend:
    store: Any
    read_only: bool = False


def Local(path: str) -> Backend:
    """Local filesystem backend (reference: vecgo.Local)."""
    return Backend(store=path)


def Remote(store: BlobStore, read_only: bool = False) -> Backend:
    """Shared blob-store backend; read_only=True for stateless read replicas
    (reference: vecgo.Remote, vecgo.go:151-179)."""
    return Backend(store=store, read_only=read_only)


def Memory() -> Backend:
    """Ephemeral in-memory backend (tests/experiments)."""
    return Backend(store=MemoryStore())


def Create(dim: int, metric: Metric = Metric.L2, **kw) -> EngineOptions:
    """Creation options; `device=` picks the device (default "cuda")."""
    return EngineOptions(dim=dim, metric=metric, **kw)


class DB:
    """Embeddable handle; thin delegation to the engine (reference: vecgo.DB)."""

    def __init__(self, engine: Engine):
        self.engine = engine

    # CRUD
    def insert(self, vector, metadata=None, payload=None, text=None, id=None) -> int:
        return self.engine.insert(vector, metadata, payload, text, id)

    def insert_batch(self, vectors, metadatas=None, payloads=None, texts=None, ids=None):
        return self.engine.insert_batch(vectors, metadatas, payloads, texts, ids)

    def delete(self, id: int) -> bool:
        return self.engine.delete(id)

    def get(self, id: int):
        return self.engine.get(id)

    def scan(self):
        return self.engine.scan()

    # Search
    def search(self, q, k: int = 10, **kw):
        return self.engine.search(q, k, **kw)

    def search_iter(self, q, k: int = 10, **kw):
        """Iterator over candidates best-first (reference: SearchIter,
        engine/search.go:120). Results are computed in one device batch; the
        iterator form is API parity for streaming consumers."""
        yield from self.engine.search(q, k, **kw)

    def search_batch(self, qs, k: int = 10, **kw):
        return self.engine.search_batch(qs, k, **kw)

    def search_arrays(self, qs, k: int = 10, **kw):
        """Bulk serving path: (ids, dists) arrays, pipelined chunks."""
        return self.engine.search_arrays(qs, k, **kw)

    def search_arrays_stream(self, batches, k: int = 10, depth: int = 3, **kw):
        """Sustained serving: keep `depth` query batches in flight; yields
        (ids, dists) per batch (one consistent snapshot for the stream)."""
        return self.engine.search_arrays_stream(batches, k, depth=depth, **kw)

    def hybrid_search(self, q, text: str, k: int = 10, **kw):
        return self.engine.hybrid_search(q, text, k, **kw)

    def hybrid_search_batch(self, qs, texts, k: int = 10, **kw):
        return self.engine.hybrid_search_batch(qs, texts, k, **kw)

    def sharded_searcher(self, mesh):
        """Multi-chip searcher over the committed snapshot (parallel plane)."""
        return self.engine.sharded_searcher(mesh)

    # Durability / maintenance
    def commit(self) -> int:
        return self.engine.commit()

    def compact(self, seg_ids=None):
        return self.engine.compact(seg_ids)

    def vacuum(self):
        return self.engine.vacuum()

    def versions(self):
        return self.engine.versions()

    def stats(self):
        return self.engine.stats()

    def close(self):
        self.engine.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def Open(
    backend: Backend,
    options: Optional[EngineOptions] = None,
    version: Optional[int] = None,
    as_of: Optional[float] = None,
    device=None,
) -> DB:
    """Open or create a database. `device`, when given, overrides the
    options' device; `version`/`as_of` open a read-only time-travel view."""
    create = options is not None and options.dim > 0
    if options is None:
        options = EngineOptions(device=device or "cuda")
    elif device is not None:
        options = replace(options, device=device)
    if backend.read_only:
        options.read_only = True
    return DB(Engine.open(backend.store, options, version=version, as_of=as_of, create=create))
