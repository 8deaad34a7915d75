"""Peaks of one NVIDIA H100 SXM and the operations and bytes each scan needs.

Frozen: later changes to the program are measured against these counts.
A roofline share is the least time the card could take for the work the
inputs need (the larger of operations over the peak rate of their type and
bytes over the HBM bandwidth, each input byte read once and each output byte
written once), divided by the measured device time, whatever kernel does
the work.
"""

from __future__ import annotations

# Published dense peaks at the 700 W power limit (NVIDIA data sheet, SXM).
PEAK_BF16 = 989e12  # FLOP/s on the tensor cores
PEAK_TF32 = 495e12
PEAK_F32 = 67e12  # FLOP/s on the FMA units
HBM_BPS = 3.35e12  # bytes/s

_PEAKS = {"bf16": PEAK_BF16, "tf32": PEAK_TF32, "f32": PEAK_F32}
_TABLE_BYTES = {"bf16": 2, "f32": 4}


def bound_s(flop: float, nbytes: float, kind: str = "bf16") -> float:
    """Seconds the card needs at least: operations at the peak of `kind`
    ("bf16", "tf32" or "f32") against bytes at 3.35 TB/s."""
    return max(flop / _PEAKS[kind], nbytes / HBM_BPS)


def scan_work(b: int, n: int, d: int, k_pool: int, table: str = "bf16",
              masked: bool = False) -> tuple:
    """(operations, bytes) of one exact top-k scan of B f32 queries over an
    N x d table: 2·B·N·d multiply-adds; the table read once, the queries
    (f32), a row mask (one byte a row) where there is one, and the B x pool
    (f32 distance, int32 row) outputs written once."""
    flop = 2.0 * b * n * d
    nbytes = (_TABLE_BYTES[table] * n * d + 4.0 * b * d + 8.0 * b * k_pool
              + (n if masked else 0))
    return flop, nbytes


def scan_bound_s(b: int, n: int, d: int, k_pool: int, table: str = "bf16",
                 masked: bool = False) -> float:
    """The least time of one scan (`scan_work`) on the card: a bf16 table's
    product at the bf16 tensor-core peak; an f32 table's at the TF32 peak,
    one pass (no product of f32 inputs on the tensor cores takes less; the
    port's fp32-class split product makes three)."""
    flop, nbytes = scan_work(b, n, d, k_pool, table, masked)
    return bound_s(flop, nbytes, "bf16" if table == "bf16" else "tf32")


def share_pct(bound: float, measured: float):
    """The roofline share in percent, or None where nothing was measured.
    Never clamped: a share above 100 means the count or the time is wrong."""
    if measured <= 0:
        return None
    return 100.0 * bound / measured
