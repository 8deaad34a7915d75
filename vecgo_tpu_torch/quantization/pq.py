"""Product quantization (PQ) and optimized PQ (OPQ): port of
vecgo_tpu/quantization/pq.py.

Classic ADC, sum_m |q_m - C_m[code]|^2, equals the exact L2 between q and the
PQ *reconstruction*, so scoring decodes a code block to bf16 (a codebook
gather: the JAX package's one-hot products exist to avoid gathers on a TPU
and give the same bf16 rows) and takes the norm-expanded product. Codes stay
compressed on the device. All M codebooks train at once
(`kmeans.train_kmeans_grouped`); assignment runs on the quantizer's device.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from vecgo_tpu_torch.model import Metric
from vecgo_tpu_torch.ops import distance as D
from vecgo_tpu_torch.quantization import Quantizer, bf16_product, recon_scores, register
from vecgo_tpu_torch.quantization import kmeans as km
from vecgo_tpu_torch.utils.tensors import host_tensor


def _pad_dim(x: np.ndarray, m: int) -> np.ndarray:
    d = x.shape[1]
    pad = (-d) % m
    if pad:
        x = np.concatenate([x, np.zeros((x.shape[0], pad), np.float32)], 1)
    return x


def code_indices(codes: torch.Tensor) -> torch.Tensor:
    """Stored codes (uint8, or uint16 held as int16 bytes) as int64 indices."""
    if codes.dtype == torch.int16:
        return codes.long() & 0xFFFF
    return codes.long()


@register
class PQQuantizer(Quantizer):
    """Product quantizer, `ksub` centroids per subspace."""

    kind = "pq"

    def __init__(self, dim: int, m: int = 8, ksub: int = 256, device=None):
        super().__init__(dim, device)
        self.m = m
        self.ksub = ksub
        self.dsub = (dim + m - 1) // m  # after zero-padding dim to a multiple of m
        self.dim_padded = self.dsub * m
        self.codebooks = None  # [M, K, dsub] f32

    def train(self, x: np.ndarray, seed: int = 42):
        x = _pad_dim(np.asarray(x, np.float32), self.m)
        groups = x.reshape(x.shape[0], self.m, self.dsub).transpose(1, 0, 2)
        self.codebooks = km.train_kmeans_grouped(groups, self.ksub, seed=seed,
                                                 device=self._train_device())
        self._dev_arrays.clear()
        self.trained = True

    def _assign(self, x: np.ndarray) -> np.ndarray:
        """codes [N, M] uint8/uint16: the nearest centroid per subspace (IEEE
        f32; the lower index where two tie)."""
        x = _pad_dim(np.asarray(x, np.float32), self.m)
        n = x.shape[0]
        groups = x.reshape(n, self.m, self.dsub)
        cb = self._on("codebooks", self._train_device())  # [M, K, dsub]
        cn = (cb * cb).sum(-1)  # [M, K]
        block = 8192
        out = np.empty((n, self.m), np.int32)
        for s in range(0, n, block):
            g = host_tensor(groups[s : s + block]).to(cb.device)
            g = g.transpose(0, 1)  # [M, b, dsub]
            dmat = ((g * g).sum(-1)[:, :, None] + cn[:, None, :]
                    - 2.0 * torch.bmm(g, cb.transpose(1, 2))).clamp_min(0.0)
            out[s : s + block] = dmat.argmin(dim=2).T.cpu().numpy()
        return out.astype(np.uint8 if self.ksub <= 256 else np.uint16)

    def encode(self, x: np.ndarray) -> Dict[str, np.ndarray]:
        codes = self._assign(x)
        recon = self._decode_codes(codes)
        rnorm2 = np.einsum("nd,nd->n", recon, recon, dtype=np.float64).astype(np.float32)
        return {"codes": codes, "rnorm2": rnorm2}

    def _decode_codes(self, codes: np.ndarray) -> np.ndarray:
        recon = np.empty((codes.shape[0], self.dim_padded), np.float32)
        for m in range(self.m):
            recon[:, m * self.dsub : (m + 1) * self.dsub] = self.codebooks[m][
                codes[:, m].astype(np.int64)
            ]
        return recon[:, : self.dim]

    def decode(self, enc) -> np.ndarray:
        return self._decode_codes(np.asarray(enc["codes"]))

    def _decode_block(self, codes: torch.Tensor) -> torch.Tensor:
        """codes [Nb, M] -> reconstruction [Nb, M*dsub] bf16 (each entry the
        codebook value rounded to bf16)."""
        cb16 = self._dev_arrays.get(("cb16", str(codes.device)))
        if cb16 is None:
            cb16 = self._on("codebooks", codes.device).to(torch.bfloat16)
            self._dev_arrays[("cb16", str(codes.device))] = cb16
        sub = torch.arange(self.m, device=codes.device)[None, :]
        return cb16[sub, code_indices(codes)].reshape(codes.shape[0], self.dim_padded)

    def _query(self, q: torch.Tensor, metric: Metric) -> torch.Tensor:
        qf = q.float()
        if metric == Metric.COSINE:
            qf = D.normalize(qf)
        if self.dim_padded != self.dim:
            qf = torch.nn.functional.pad(qf, (0, self.dim_padded - self.dim))
        return qf

    def score(self, q, enc, metric: Metric):
        qf = self._query(q, metric)
        dotp = bf16_product(qf, self._decode_block(enc["codes"]))
        return recon_scores(qf, dotp, enc["rnorm2"], metric, "PQ")

    def scan_form(self, q, metric: Metric):
        if metric not in (Metric.L2, Metric.DOT):
            return None
        return self._query(q, metric).contiguous(), None, metric

    def scan_table(self, enc):
        return self._decode_block(enc["codes"]), enc["rnorm2"]

    def code_bytes_per_vector(self) -> int:
        return self.m * (1 if self.ksub <= 256 else 2) + 4

    def params(self):
        return {"dim": self.dim, "m": self.m, "ksub": self.ksub}

    def arrays(self):
        return {"codebooks": self.codebooks}


@register
class OPQQuantizer(Quantizer):
    """PQ with a learned orthogonal rotation: alternates PQ training on
    rotated data with a procrustes update R = U V^T from the SVD of
    X^T Xhat."""

    kind = "opq"

    def __init__(self, dim: int, m: int = 8, ksub: int = 256, opq_iters: int = 5,
                 device=None):
        super().__init__(dim, device)
        self.m = m
        self.ksub = ksub
        self.opq_iters = opq_iters
        self.pq = PQQuantizer(dim, m, ksub, device=device)
        self.rotation = None  # [d, d] f32, applied as x @ R

    def train(self, x: np.ndarray, seed: int = 42):
        x = np.asarray(x, np.float32)
        r = np.random.default_rng(seed)
        n = min(x.shape[0], 16384)
        xs = x[r.choice(x.shape[0], n, replace=False)] if x.shape[0] > n else x
        self.rotation = np.eye(self.dim, dtype=np.float32)
        for it in range(self.opq_iters):
            xr = xs @ self.rotation
            self.pq.train(xr, seed=seed + it)
            recon = self.pq.decode(self.pq.encode(xr))
            # Procrustes: maximize tr(R^T X^T Xhat) over orthogonal R.
            u, _, vt = np.linalg.svd(xs.T @ recon, full_matrices=False)
            self.rotation = (u @ vt).astype(np.float32)
        # Final PQ fit in the converged rotation.
        self.pq.train(xs @ self.rotation, seed=seed + 1000)
        self._dev_arrays.clear()
        self.trained = True

    def encode(self, x: np.ndarray) -> Dict[str, np.ndarray]:
        return self.pq.encode(np.asarray(x, np.float32) @ self.rotation)

    def decode(self, enc) -> np.ndarray:
        return self.pq.decode(enc) @ self.rotation.T

    def _rotated(self, q: torch.Tensor, metric: Metric) -> torch.Tensor:
        qf = q.float()
        if metric == Metric.COSINE:
            qf = D.normalize(qf)
        return qf @ self._on("rotation", q.device)

    def score(self, q, enc, metric: Metric):
        # The rotation is orthogonal: L2, dot and cosine are invariant, so
        # scoring happens in rotated space (a rotated unit query stays unit,
        # and the stored norms are those of the rotated reconstruction).
        qr = self._rotated(q, metric)
        if metric == Metric.COSINE:
            dotp = -self.pq.score(qr, enc, Metric.DOT)
            inv = torch.rsqrt(enc["rnorm2"].clamp_min(1e-30))
            return 1.0 - dotp * inv[None, :]
        return self.pq.score(qr, enc, metric)

    def scan_form(self, q, metric: Metric):
        if metric not in (Metric.L2, Metric.DOT):
            return None
        return self.pq.scan_form(self._rotated(q, metric), metric)

    def scan_table(self, enc):
        return self.pq.scan_table(enc)

    def code_bytes_per_vector(self) -> int:
        return self.pq.code_bytes_per_vector()

    def params(self):
        return {"dim": self.dim, "m": self.m, "ksub": self.ksub, "opq_iters": self.opq_iters}

    def arrays(self):
        return {"rotation": self.rotation, "codebooks": self.pq.codebooks}

    def load_arrays(self, arrays):
        self.rotation = arrays["rotation"]
        self.pq.codebooks = arrays["codebooks"]
        self.pq._dev_arrays.clear()
        self.pq.trained = True
        self._dev_arrays.clear()
        self.trained = True
