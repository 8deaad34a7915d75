"""Quantization suite of the port (vecgo_tpu/quantization): none / SQ8 / INT4 /
PQ / OPQ / BQ / RaBitQ.

`train`, `encode` and `decode` are host numpy, as in the JAX package, so codes
and trained arrays are byte for byte its own wherever no k-means is involved
(PQ and OPQ train their codebooks with the port's k-means and assign on the
device). State round-trips through the same `state()` / `from_state` and the
same meta entry and `q.*` / `enc.*` sections.

Every quantizer scores against its *reconstruction*, with the reconstruction
norms precomputed at encode time, so L2 is |q|^2 + rnorm2[n] - 2 q . xhat_n.
Codes stay compressed on the device; a block is decoded transiently. Two ways
to score a block:

- `score(q, enc, metric)`: the plain [B, N] score matrix (a product of
  operands rounded to bf16, summed in f32, as the JAX package computes it).
- `scan_form(q, metric)` with `scan_table(enc)`: where the score has the form
  of `scan_topk` (a product against a decoded bf16 table plus stored row
  norms, up to a per-query constant), the transformed query, the constant and
  the kernel's metric. The block scans hand these to the fused kernel, which
  never holds the score matrix. `scan_form` returns None where the form does
  not fit (cosine's and RaBitQ's per-row factors, symmetric Hamming): those
  blocks go through `score`.

The device a quantizer trains and assigns on is not part of its state: it is
passed beside `params()` (`create(kind, device=..., **params)`).
"""

from __future__ import annotations

import abc
from typing import Any, ClassVar, Dict, Optional, Tuple

import numpy as np
import torch

from vecgo_tpu_torch.model import Metric
from vecgo_tpu_torch.ops import distance as D
from vecgo_tpu_torch.utils.tensors import host_tensor


def bf16_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [B, d] . b [N, d]^T -> [B, N] f32: both operands rounded to bf16,
    products summed in f32 (a bf16 matmul would round the result too)."""
    return a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float().T


def recon_scores(qf: torch.Tensor, dotp: torch.Tensor, rnorm2: torch.Tensor,
                 metric: Metric, what: str) -> torch.Tensor:
    """Scores [B, N] from q . xhat products and reconstruction norms."""
    if metric == Metric.L2:
        qn = (qf * qf).sum(-1, keepdim=True)
        return (qn + rnorm2[None, :] - 2.0 * dotp).clamp_min(0.0)
    if metric == Metric.DOT:
        return -dotp
    if metric == Metric.COSINE:
        inv = torch.rsqrt(rnorm2.clamp_min(1e-30))
        return 1.0 - dotp * inv[None, :]
    raise ValueError(f"metric {metric} unsupported by {what}")


class Quantizer(abc.ABC):
    """Quantizer contract: construct -> train(sample) -> encode(rows) ->
    score(q, codes). State round-trips through state()/from_state."""

    kind: ClassVar[str] = "none"

    def __init__(self, dim: int, device=None):
        self.dim = dim
        self.trained = False
        self.device = device  # None = the card
        self._dev_arrays: Dict[Any, torch.Tensor] = {}

    def _train_device(self) -> torch.device:
        return torch.device(self.device if self.device is not None else "cuda")

    def _on(self, name: str, device) -> torch.Tensor:
        """A trained array as an f32 tensor on `device` (uploaded once)."""
        key = (name, str(device))
        t = self._dev_arrays.get(key)
        if t is None:
            t = host_tensor(np.asarray(getattr(self, name), np.float32)).to(device)
            self._dev_arrays[key] = t
        return t

    @abc.abstractmethod
    def train(self, x: np.ndarray, seed: int = 42) -> None:
        """Fit quantizer parameters on a training sample [N, d]."""

    @abc.abstractmethod
    def encode(self, x: np.ndarray) -> Dict[str, np.ndarray]:
        """Encode rows into named code arrays (each leading dim N)."""

    @abc.abstractmethod
    def decode(self, enc: Dict[str, np.ndarray]) -> np.ndarray:
        """Reconstruct float32 approximations [N, d] (host)."""

    @abc.abstractmethod
    def score(self, q: torch.Tensor, enc: Dict[str, torch.Tensor], metric: Metric):
        """Approximate distances [B, N] f32 (enc holds tensors on q's device)."""

    def scan_form(self, q: torch.Tensor, metric: Metric
                  ) -> Optional[Tuple[torch.Tensor, Optional[torch.Tensor], Metric]]:
        """(q' [B, d'] f32, const [B] f32 or None, kernel metric) such that
        score(q, enc, metric) = scan_topk's score of q' against
        scan_table(enc) under the kernel metric, plus const per query
        (clamped at 0 for L2); None where the score has no such form."""
        return None

    def scan_table(self, enc: Dict[str, torch.Tensor]):
        """(table [N, d'] bf16 or f32, row norms [N] f32) of a code block."""
        raise NotImplementedError

    @abc.abstractmethod
    def code_bytes_per_vector(self) -> int:
        """Compressed bytes per vector (excluding shared codebooks)."""

    def params(self) -> Dict[str, Any]:
        """JSON-able constructor params."""
        return {"dim": self.dim}

    def arrays(self) -> Dict[str, np.ndarray]:
        """Trained parameter arrays."""
        return {}

    def load_arrays(self, arrays: Dict[str, np.ndarray]) -> None:
        for name, arr in arrays.items():
            setattr(self, name, arr)
        self._dev_arrays.clear()
        self.trained = True

    def state(self) -> Dict[str, Any]:
        return {"kind": self.kind, "params": self.params(), "arrays": self.arrays()}

    @staticmethod
    def from_state(state: Dict[str, Any], device=None) -> "Quantizer":
        q = create(state["kind"], device=device, **state["params"])
        q.load_arrays(state.get("arrays", {}))
        return q


class NoneQuantizer(Quantizer):
    """Identity quantizer: full-precision float32 storage."""

    kind = "none"

    def __init__(self, dim: int = 0, device=None):
        super().__init__(dim, device)

    def train(self, x, seed: int = 42) -> None:
        self.trained = True

    def encode(self, x):
        x = np.asarray(x, np.float32)
        return {
            "vectors": x,
            "rnorm2": np.asarray(np.einsum("nd,nd->n", x, x, dtype=np.float64), np.float32),
        }

    def decode(self, enc):
        return np.asarray(enc["vectors"], np.float32)

    def score(self, q, enc, metric: Metric):
        return D.pairwise_scores(q, enc["vectors"], metric, x_norms_sq=enc.get("rnorm2"),
                                 x_normalized=False)

    def scan_form(self, q, metric: Metric):
        metric = metric.compute()
        if metric not in (Metric.L2, Metric.DOT, Metric.COSINE):
            return None
        qf = q.float()
        # Cosine rows are stored normalized; the query is normalized here.
        return (D.normalize(qf) if metric == Metric.COSINE else qf).contiguous(), None, metric

    def scan_table(self, enc):
        return enc["vectors"], enc["rnorm2"]

    def code_bytes_per_vector(self) -> int:
        return self.dim * 4


_REGISTRY: Dict[str, type] = {}


def register(cls):
    _REGISTRY[cls.kind] = cls
    return cls


register(NoneQuantizer)


def create(kind: str, device=None, **params) -> Quantizer:
    """Create an untrained quantizer by kind name. `device` is where PQ and
    OPQ train and assign (None = the card); it is not part of `params()`."""
    from vecgo_tpu_torch.quantization import binary, pq, scalar  # noqa: F401  (registry)

    if kind in (None, "", "none"):
        return NoneQuantizer(params.get("dim", 0), device)
    if kind not in _REGISTRY:
        raise ValueError(f"unknown quantizer kind {kind!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[kind](device=device, **params)


__all__ = ["Quantizer", "NoneQuantizer", "create", "register", "Metric"]
