"""vecgo_tpu_torch — the vecgo_tpu engine on PyTorch and CUDA (NVIDIA H100).

The port keeps `vecgo_tpu`'s layout, API and on-disk format. It carries its
own copy of the host control plane (model, errors, metadata, storage,
blobstore, manifests, PK index, tombstones, planner, engine) under the same
relative paths, and replaces every device path: plain PyTorch for tensor
code, and hand-written CUDA kernels (`csrc/`) where the JAX package had
Pallas ones. It imports neither jax nor `vecgo_tpu`.
"""

from vecgo_tpu_torch.errors import (
    ErrBackpressure,
    ErrClosed,
    ErrDimensionMismatch,
    ErrInvalidVector,
    ErrNotFound,
    ErrReadOnly,
    VecgoError,
)
from vecgo_tpu_torch.model import Candidate, Metric, QueryStats, Record, SearchOptions, SearchResult
from vecgo_tpu_torch.api import DB, Backend, Create, Local, Memory, Open, Remote

__version__ = "0.1.0"

__all__ = [
    "Backend", "Candidate", "Create", "DB", "ErrBackpressure", "ErrClosed",
    "ErrDimensionMismatch", "ErrInvalidVector", "ErrNotFound", "ErrReadOnly",
    "Local", "Memory", "Metric", "Open", "QueryStats", "Record", "Remote",
    "SearchOptions", "SearchResult", "VecgoError",
]
