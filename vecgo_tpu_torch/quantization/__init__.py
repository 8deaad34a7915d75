"""Quantizer registry of the port: only the identity ("none") so far.

`vecgo_tpu.quantization.create` imports every quantizer module, and each of
those loads jax, so even the unquantized flat writer and segment need this
jax-free registry. Its state round-trips through the same meta entry
(`{"kind": "none", "params": {"dim": d}}`) as the JAX package's. The graph
build's k-means is `vecgo_tpu_torch.quantization.kmeans`.
"""

from __future__ import annotations

from typing import Any, Dict

from vecgo_tpu_torch._roadmap import not_ported


class NoneQuantizer:
    """Identity quantizer: full-precision float32 storage."""

    kind = "none"

    def __init__(self, dim: int = 0):
        self.dim = dim
        self.trained = False

    def train(self, x, seed: int = 42) -> None:
        self.trained = True

    def params(self) -> Dict[str, Any]:
        return {"dim": self.dim}

    @staticmethod
    def from_state(state: Dict[str, Any]) -> "NoneQuantizer":
        q = create(state["kind"], **state["params"])
        q.trained = True
        return q


def create(kind: str, **params) -> NoneQuantizer:
    """Create an untrained quantizer by kind name."""
    if kind in (None, "", "none"):
        return NoneQuantizer(params.get("dim", 0))
    raise not_ported(f"quantizer {kind!r}", 2)


__all__ = ["NoneQuantizer", "create"]
