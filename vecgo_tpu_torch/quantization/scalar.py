"""Scalar quantizers: SQ8 and INT4 (port of vecgo_tpu/quantization/scalar.py).

Both are per-dimension affine codecs  x ~= offset + scale * u  with u in
[0, 255] (SQ8) or [0, 15] (INT4, nibble-packed). With q' = q * scale,

    q . xhat = q . offset + q' . u

so a block scan multiplies the code matrix itself (small integers, exact in
bf16) and adds q . offset per query: for L2 and DOT that is `scan_topk`'s
form (`scan_form`); cosine divides by each row's reconstruction norm and
stays a plain score matrix.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from vecgo_tpu_torch.model import Metric
from vecgo_tpu_torch.ops import distance as D
from vecgo_tpu_torch.quantization import Quantizer, bf16_product, recon_scores, register


def _affine_train(x: np.ndarray, levels: int):
    lo = x.min(axis=0).astype(np.float32)
    hi = x.max(axis=0).astype(np.float32)
    scale = (hi - lo) / (levels - 1)
    scale = np.where(scale <= 0, 1e-9, scale).astype(np.float32)
    return lo, scale


def _affine_encode(x: np.ndarray, offset, scale, levels: int):
    u = np.rint((x - offset[None, :]) / scale[None, :])
    return np.clip(u, 0, levels - 1).astype(np.uint8)


def _rnorm2(recon: np.ndarray) -> np.ndarray:
    return np.einsum("nd,nd->n", recon, recon, dtype=np.float64).astype(np.float32)


def pack_nibbles(u: np.ndarray) -> np.ndarray:
    """Pack uint8 values <16, [N, d] -> [N, ceil(d/2)]; even dims in low nibble."""
    n, d = u.shape
    if d % 2:
        u = np.concatenate([u, np.zeros((n, 1), np.uint8)], 1)
    return (u[:, 0::2] | (u[:, 1::2] << 4)).astype(np.uint8)


def unpack_nibbles(packed: torch.Tensor, d: int) -> torch.Tensor:
    """[Nb, ceil(d/2)] uint8 -> [Nb, d] uint8 (on the tensor's device)."""
    inter = torch.stack([packed & 0x0F, packed >> 4], dim=-1)
    return inter.reshape(packed.shape[0], -1)[:, :d]


class _AffineQuantizer(Quantizer):
    """x ~= offset + scale * u with `levels` levels per dimension."""

    levels: int = 256

    def __init__(self, dim: int, device=None):
        super().__init__(dim, device)
        self.offset = None  # [d] f32
        self.scale = None  # [d] f32

    def train(self, x: np.ndarray, seed: int = 42):
        self.offset, self.scale = _affine_train(np.asarray(x, np.float32), self.levels)
        self._dev_arrays.clear()
        self.trained = True

    def _levels_of(self, codes: torch.Tensor) -> torch.Tensor:
        """The integer levels u [Nb, d] of a block of stored codes."""
        return codes

    def _query(self, q: torch.Tensor, metric: Metric):
        qf = q.float()
        if metric == Metric.COSINE:
            qf = D.normalize(qf)
        return qf, qf * self._on("scale", q.device)[None, :]

    def score(self, q, enc, metric: Metric):
        qf, qs = self._query(q, metric)
        dotp = bf16_product(qs, self._levels_of(enc["codes"]))
        dotp = dotp + (qf @ self._on("offset", q.device))[:, None]
        return recon_scores(qf, dotp, enc["rnorm2"], metric, "scalar quantizer")

    def scan_form(self, q, metric: Metric):
        if metric not in (Metric.L2, Metric.DOT):
            return None
        qf, qs = self._query(q, metric)
        qo = qf @ self._on("offset", q.device)
        if metric == Metric.DOT:
            return qs.contiguous(), -qo, metric
        # |q|^2 + rn - 2 (q'.u + q.offset) = (|q'|^2 + rn - 2 q'.u) + const
        const = (qf * qf).sum(-1) - (qs * qs).sum(-1) - 2.0 * qo
        return qs.contiguous(), const, metric

    def scan_table(self, enc):
        return self._levels_of(enc["codes"]).to(torch.bfloat16), enc["rnorm2"]

    def params(self):
        return {"dim": self.dim}

    def arrays(self):
        return {"offset": self.offset, "scale": self.scale}


@register
class SQ8Quantizer(_AffineQuantizer):
    """8-bit scalar quantization, 4x compression."""

    kind = "sq8"
    levels = 256

    def encode(self, x: np.ndarray) -> Dict[str, np.ndarray]:
        x = np.asarray(x, np.float32)
        codes = _affine_encode(x, self.offset, self.scale, 256)
        recon = self.offset[None, :] + self.scale[None, :] * codes.astype(np.float32)
        return {"codes": codes, "rnorm2": _rnorm2(recon)}

    def decode(self, enc) -> np.ndarray:
        codes = np.asarray(enc["codes"], np.float32)
        return self.offset[None, :] + self.scale[None, :] * codes

    def code_bytes_per_vector(self) -> int:
        return self.dim + 4


@register
class INT4Quantizer(_AffineQuantizer):
    """4-bit scalar quantization, 8x compression."""

    kind = "int4"
    levels = 16

    def _levels_of(self, codes):
        return unpack_nibbles(codes, self.dim)

    def encode(self, x: np.ndarray) -> Dict[str, np.ndarray]:
        x = np.asarray(x, np.float32)
        u = _affine_encode(x, self.offset, self.scale, 16)
        recon = self.offset[None, :] + self.scale[None, :] * u.astype(np.float32)
        return {"codes": pack_nibbles(u), "rnorm2": _rnorm2(recon)}

    def decode(self, enc) -> np.ndarray:
        packed = np.asarray(enc["codes"])
        u = np.stack([packed & 0x0F, packed >> 4], -1).reshape(packed.shape[0], -1)[:, : self.dim]
        return self.offset[None, :] + self.scale[None, :] * u.astype(np.float32)

    def code_bytes_per_vector(self) -> int:
        return (self.dim + 1) // 2 + 4
