"""Binary quantizers: BQ and RaBitQ (port of vecgo_tpu/quantization/binary.py).

Storage: packed sign/threshold bits (uint32 words, 32x compression) plus
small per-row float corrections. Scoring unpacks a block to +-1 bf16 and
takes one product (ops/hamming.py). BQ's L2 and DOT have `scan_topk`'s form
(the per-dimension alpha goes into the query); BQ's cosine and Hamming, and
all of RaBitQ (a per-row factor on the product), stay plain score matrices.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from vecgo_tpu_torch.model import Metric
from vecgo_tpu_torch.ops import distance as D
from vecgo_tpu_torch.ops import hamming as H
from vecgo_tpu_torch.quantization import Quantizer, bf16_product, recon_scores, register


def _pm_matmul(q_weighted: torch.Tensor, packed_block, d: int) -> torch.Tensor:
    """q_weighted [B, d] . pm(codes) [Nb, d] -> [B, Nb] f32."""
    return bf16_product(q_weighted, H.unpack_to_pm1(packed_block, d))


@register
class BQQuantizer(Quantizer):
    """Binary (threshold) quantization.

    encode: bit_d = x_d > t_d with per-dim threshold t = sample mean.
    reconstruction: xhat = t + alpha * pm with per-dim alpha = E|x - t|.
    Scoring: asymmetric (float query vs +-1 codes) for L2/DOT/COSINE;
    symmetric Hamming for Metric.HAMMING (binarized query).
    """

    kind = "bq"

    def __init__(self, dim: int, device=None):
        super().__init__(dim, device)
        self.threshold = None  # [d] f32
        self.alpha = None  # [d] f32

    def train(self, x: np.ndarray, seed: int = 42):
        x = np.asarray(x, np.float32)
        self.threshold = x.mean(axis=0).astype(np.float32)
        self.alpha = np.abs(x - self.threshold[None, :]).mean(0).astype(np.float32)
        self.alpha = np.where(self.alpha <= 0, 1e-9, self.alpha)
        self._dev_arrays.clear()
        self.trained = True

    def encode(self, x: np.ndarray) -> Dict[str, np.ndarray]:
        x = np.asarray(x, np.float32)
        bits = x > self.threshold[None, :]
        recon = self.threshold[None, :] + self.alpha[None, :] * np.where(bits, 1, -1)
        rnorm2 = np.einsum("nd,nd->n", recon, recon, dtype=np.float64).astype(np.float32)
        return {"codes": H.pack_bits_np(bits), "rnorm2": rnorm2}

    def decode(self, enc) -> np.ndarray:
        bits = H.unpack_bits_np(np.asarray(enc["codes"]), self.dim)
        return self.threshold[None, :] + self.alpha[None, :] * (
            2.0 * bits.astype(np.float32) - 1.0
        )

    def encode_query(self, q: np.ndarray) -> np.ndarray:
        """Binarize queries for symmetric Hamming scoring."""
        return H.pack_bits_np(np.asarray(q, np.float32) > self.threshold[None, :])

    def _query(self, q: torch.Tensor, metric: Metric):
        qf = q.float()
        if metric == Metric.COSINE:
            qf = D.normalize(qf)
        return qf, qf * self._on("alpha", q.device)[None, :]

    def score(self, q, enc, metric: Metric):
        if metric == Metric.HAMMING:
            # q is expected packed here (see encode_query).
            return H.hamming_scores(q, enc["codes"], self.dim)
        qf, qa = self._query(q, metric)
        dotp = _pm_matmul(qa, enc["codes"], self.dim)
        dotp = dotp + (qf @ self._on("threshold", q.device))[:, None]
        return recon_scores(qf, dotp, enc["rnorm2"], metric, "BQ")

    def scan_form(self, q, metric: Metric):
        if metric not in (Metric.L2, Metric.DOT):
            return None
        qf, qa = self._query(q, metric)
        qt = qf @ self._on("threshold", q.device)
        if metric == Metric.DOT:
            return qa.contiguous(), -qt, metric
        const = (qf * qf).sum(-1) - (qa * qa).sum(-1) - 2.0 * qt
        return qa.contiguous(), const, metric

    def scan_table(self, enc):
        return H.unpack_to_pm1(enc["codes"], self.dim), enc["rnorm2"]

    def code_bytes_per_vector(self) -> int:
        return 4 * H.packed_words(self.dim) + 4

    def params(self):
        return {"dim": self.dim}

    def arrays(self):
        return {"threshold": self.threshold, "alpha": self.alpha}


@register
class RaBitQQuantizer(Quantizer):
    """RaBitQ: centered sign bits + norm/cosine correction.

    encode (per row): res = x - centroid; store packed sign bits of res,
    norm = |res|, and corr = <res/|res|, pm/sqrt(d)> (the quantization cosine).
    The unbiased dot estimator is

        <q - c, res> ~= |res| * (<q - c, pm> / sqrt(d)) / corr

    with a relative error of about 1/(corr*sqrt(d)) per row.
    """

    kind = "rabitq"

    def __init__(self, dim: int, device=None):
        super().__init__(dim, device)
        self.centroid = None  # [d] f32

    def train(self, x: np.ndarray, seed: int = 42):
        self.centroid = np.asarray(x, np.float32).mean(axis=0).astype(np.float32)
        self._dev_arrays.clear()
        self.trained = True

    def encode(self, x: np.ndarray) -> Dict[str, np.ndarray]:
        x = np.asarray(x, np.float32)
        res = x - self.centroid[None, :]
        norm = np.linalg.norm(res, axis=1).astype(np.float32)
        bits = res > 0
        pm = np.where(bits, 1.0, -1.0).astype(np.float32)
        sqrt_d = np.sqrt(self.dim)
        with np.errstate(invalid="ignore", divide="ignore"):
            corr = (res * pm).sum(1) / np.maximum(norm, 1e-30) / sqrt_d
        corr = np.clip(np.nan_to_num(corr, nan=1.0), 0.05, 1.0).astype(np.float32)
        # Everything per row folds into one factor: est = <qc, pm> * fac
        fac = (norm / (corr * sqrt_d)).astype(np.float32)
        return {"codes": H.pack_bits_np(bits), "fac": fac,
                "norm2": (norm**2).astype(np.float32)}

    def decode(self, enc) -> np.ndarray:
        bits = H.unpack_bits_np(np.asarray(enc["codes"]), self.dim)
        pm = 2.0 * bits.astype(np.float32) - 1.0
        fac = np.asarray(enc["fac"], np.float64)  # |res| / (corr * sqrt(d))
        norm2 = np.asarray(enc["norm2"], np.float64)
        # Least-squares reconstruction: res ~= alpha * pm with
        # alpha = <res, pm>/d = |res|*corr/sqrt(d) = norm2 / (fac * d).
        alpha = norm2 / np.maximum(fac * self.dim, 1e-30)
        return (self.centroid[None, :] + pm * alpha[:, None]).astype(np.float32)

    def score(self, q, enc, metric: Metric):
        qf = q.float()
        if metric == Metric.COSINE:
            qf = D.normalize(qf)
        c = self._on("centroid", q.device)
        if metric == Metric.L2:
            qc = qf - c[None, :]
            est = _pm_matmul(qc, enc["codes"], self.dim) * enc["fac"][None, :]  # ~ <qc, res>
            qcn = (qc * qc).sum(-1, keepdim=True)
            return (qcn + enc["norm2"][None, :] - 2.0 * est).clamp_min(0.0)
        # <q, x> = <q, c> + <q, res>, and <q, res> ~ <q, pm> * fac (the same
        # sign-vector estimator with q in place of q - c).
        dotp = (qf @ c)[:, None] + _pm_matmul(qf, enc["codes"], self.dim) * enc["fac"][None, :]
        if metric == Metric.DOT:
            return -dotp
        if metric == Metric.COSINE:
            inv = torch.rsqrt(((c * c).sum() + enc["norm2"]).clamp_min(1e-30))
            return 1.0 - dotp * inv[None, :]
        raise ValueError(f"metric {metric} unsupported by RaBitQ")

    def code_bytes_per_vector(self) -> int:
        return 4 * H.packed_words(self.dim) + 8

    def params(self):
        return {"dim": self.dim}

    def arrays(self):
        return {"centroid": self.centroid}
