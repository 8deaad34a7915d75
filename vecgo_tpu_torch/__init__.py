"""vecgo_tpu_torch — the vecgo_tpu engine on PyTorch and CUDA (NVIDIA H100).

The port keeps `vecgo_tpu`'s layout, API and on-disk format, imports its
host control plane (model, metadata, storage, manifests, PK index, planner)
and replaces every device path: plain PyTorch for tensor code, and
hand-written CUDA kernels (`csrc/`) where the JAX package had Pallas ones.
It never imports jax.
"""

from vecgo_tpu.errors import (
    ErrBackpressure,
    ErrClosed,
    ErrDimensionMismatch,
    ErrInvalidVector,
    ErrNotFound,
    ErrReadOnly,
    VecgoError,
)
from vecgo_tpu.model import Candidate, Metric, QueryStats, Record, SearchOptions, SearchResult
from vecgo_tpu_torch.api import DB, Backend, Create, Local, Memory, Open, Remote

__version__ = "0.1.0"

__all__ = [
    "Backend", "Candidate", "Create", "DB", "ErrBackpressure", "ErrClosed",
    "ErrDimensionMismatch", "ErrInvalidVector", "ErrNotFound", "ErrReadOnly",
    "Local", "Memory", "Metric", "Open", "QueryStats", "Record", "Remote",
    "SearchOptions", "SearchResult", "VecgoError",
]
