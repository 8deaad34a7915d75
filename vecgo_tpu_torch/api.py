"""Public API of the port (mirrors vecgo_tpu/api.py).

    import vecgo_tpu_torch as vecgo

    db = vecgo.Open(vecgo.Local("/data/db"), vecgo.Create(dim=128))
    ids = db.insert_batch(vectors)
    db.commit()
    ids, dists = db.search_arrays(queries, k=10)

Backends and the `DB` handle are the JAX package's (host code); `Create` and
`Open` build the port's engine, whose scans run on `device` ("cuda" by
default, "cpu" for the plain PyTorch path).
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional

from vecgo_tpu.api import DB, Backend, Local, Memory, Remote
from vecgo_tpu.model import Metric
from vecgo_tpu_torch.engine import Engine, EngineOptions

__all__ = ["Backend", "Create", "DB", "Local", "Memory", "Open", "Remote"]


def Create(dim: int, metric: Metric = Metric.L2, **kw) -> EngineOptions:
    """Creation options; `device=` picks the device (default "cuda")."""
    return EngineOptions(dim=dim, metric=metric, **kw)


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
