"""Packed-bit Hamming distance (port of vecgo_tpu/ops/hamming.py).

Storage stays packed: uint32 words on disk and on the host, 32 dimensions a
word, bit j of word w being dimension 32*w + j. On the device the same bytes
are held as int32 (torch has no arithmetic on uint32); every function here
reads bits with `(v >> j) & 1`, which is the same for both views. Scoring has
two paths:

1. `hamming_scores`: unpack a block of codes to {-1, 0, +1} bf16 and take one
   matrix product: hamming(a, b) = (d - a_pm . b_pm) / 2 for +-1 encodings
   with zero padding (the products are exact; they are summed in f32).
2. `hamming_scores_popcount`: XOR + SWAR popcount on the words, the
   equivalence reference, and the cheaper one for tiny candidate sets.

Packing is host work in the quantizers' `encode`, so `pack_bits_np` and
`unpack_bits_np` are the numpy forms; their bytes equal the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from vecgo_tpu_torch.utils.tensors import host_tensor


def packed_words(d: int) -> int:
    return (d + 31) // 32


def pack_bits_np(bits: np.ndarray) -> np.ndarray:
    """Pack boolean/0-1 bits [..., d] into uint32 words [..., ceil(d/32)]."""
    bits = np.asarray(bits).astype(bool)
    d = bits.shape[-1]
    w = packed_words(d)
    by = np.packbits(bits, axis=-1, bitorder="little")  # [..., ceil(d/8)] uint8
    pad = 4 * w - by.shape[-1]
    if pad:
        by = np.concatenate([by, np.zeros(by.shape[:-1] + (pad,), np.uint8)], -1)
    return np.ascontiguousarray(by).view("<u4").reshape(bits.shape[:-1] + (w,))


def unpack_bits_np(packed: np.ndarray, d: int) -> np.ndarray:
    """Unpack uint32 words [..., W] back to 0/1 int8 bits [..., d]."""
    by = np.ascontiguousarray(np.asarray(packed).astype("<u4")).view(np.uint8)
    bits = np.unpackbits(by, axis=-1, bitorder="little")
    return bits[..., :d].astype(np.int8)


def as_words(packed) -> torch.Tensor:
    """Packed words as an int32 tensor (the same bytes): takes a uint32 or
    int32 numpy array or tensor."""
    if isinstance(packed, np.ndarray):
        return host_tensor(packed.astype(np.uint32, copy=False))
    if packed.dtype == torch.int32:
        return packed
    if packed.dtype == torch.uint32:
        return packed.view(torch.int32)
    raise ValueError(f"packed words must be uint32 or int32, got {packed.dtype}")


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack boolean/0-1 bits [..., d] into words [..., ceil(d/32)] (int32
    holding the uint32 bytes)."""
    d = bits.shape[-1]
    w = packed_words(d)
    b = bits.to(torch.int64)
    if w * 32 != d:
        b = torch.nn.functional.pad(b, (0, w * 32 - d))
    b = b.reshape(b.shape[:-1] + (w, 32))
    weights = torch.ones(32, dtype=torch.int64, device=bits.device) << torch.arange(
        32, device=bits.device)
    word = (b * weights).sum(-1)  # 0 .. 2^32 - 1
    return torch.where(word >= 2**31, word - 2**32, word).to(torch.int32)


def unpack_bits(packed, d: int) -> torch.Tensor:
    """Unpack words [..., W] back to 0/1 int8 bits [..., d]."""
    v = as_words(packed)
    shifts = torch.arange(32, dtype=torch.int32, device=v.device)
    bits = (v[..., :, None] >> shifts) & 1
    return bits.reshape(v.shape[:-1] + (v.shape[-1] * 32,))[..., :d].to(torch.int8)


def unpack_to_pm1(packed, d: int, dtype=torch.bfloat16) -> torch.Tensor:
    """Unpack to +-1 [..., d] (a product over d dimensions needs no padding)."""
    return 2.0 * unpack_bits(packed, d).to(dtype) - 1.0


def popcount_u32(v: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of each 32-bit word (int32 out)."""
    v = as_words(v)
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v.long() * 0x01010101) >> 24) & 0xFF).to(torch.int32)


def hamming_scores_popcount(q_packed, x_packed) -> torch.Tensor:
    """Hamming distances [B, N] via XOR + popcount."""
    x = torch.bitwise_xor(as_words(q_packed)[:, None, :], as_words(x_packed)[None, :, :])
    return popcount_u32(x).sum(-1).float()


def hamming_scores(q_packed, x_packed, d: int) -> torch.Tensor:
    """Hamming distances [B, N] via the +-1 product identity."""
    qpm = unpack_to_pm1(q_packed, d).float()
    xpm = unpack_to_pm1(x_packed, d).float()
    return (d - qpm @ xpm.T) * 0.5
