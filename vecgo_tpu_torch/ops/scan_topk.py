"""Fused distance scan + top-k: the port of `pallas_l2_topk`.

`scan_topk` is the one kernel of the flat path. It carries the flat-segment
pool scan, the compact-gather scan, the memtable chunks, the device BM25
sweep and every quantized or streamed block scan, at any k (the kernel's
selection: unsorted candidate pools in a global scratch, compacted by radix
selection, and a finishing kernel that selects and sorts each query's k).
On a CUDA tensor it launches `csrc/scan_topk.cu` (or raises); on a CPU
tensor it runs `scan_topk_reference`, the plain PyTorch version it is
tested against. The library's plan picks one of five products by the
table's type, depth, k and alignment (`PRODUCTS`): the short bf16 product
(rows TMA can read, d up to 256: resident queries, a TMA ring, `wgmma` in
turns), the bf16 tile product (rows TMA cannot read), the deep bf16
product (past d 256), the f32 product (rows TMA can read: a split-precision
fp32 product, three tf32 passes on `wgmma`) and the FMA f32 product (f32
rows TMA cannot read);
`scan_topk.last_product` names the last launch's.

`scan_topk_columns` is the sixth product, for queries that are lists of at
most 16 columns of a bf16 table (the device BM25 sweep): each row's score
is the sum of the query's own columns, and the table is read once
(`csrc/scan_columns.cu`); it counts in `scan_topk.launches` and names its
launches "columns". `scan_topk_columns_reference` is its plain version.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from vecgo_tpu_torch.model import Metric

_METRIC_CODES = {Metric.L2: 0, Metric.DOT: 1, Metric.COSINE: 2}
# Reference blocks hold at most this many scores ([B, block] f32, 256 MB).
_REF_BLOCK_ELEMS = 1 << 26
# Corpus rows per tile of the bf16 tile product (TN in csrc/scan_topk.cu).
_TN = 64
# The finishing kernel reads every split's pool of a query: splits * pool
# entries at most this many.
_MAX_POOL_WIDTH = 65536
# A split scans at least this many tiles, so the compactions that fill its
# pools stay a small part of its work.
_MIN_TILES_PER_SPLIT = 32
# The FMA f32 product's tiles (128 x 128) are 4x the tile product's work,
# and the memtable's 8,192-row chunks are only 64 of them: 16 tiles a split
# (four splits, one wave of 128 blocks, measured fastest there; PERF.md).
_MIN_TILES_FMA = 16
# The split f32 product's units (128 queries over a split of 128-row tiles)
# walk persistent blocks as the short product's, with a bound each query's
# splits share, and split as it does (8 tiles a split: the memtable's
# 8,192-row chunks at d 96-1,536 and pools 74-1,000 read within 1.2% at 4
# tiles, 4-29% slower at 16 and 39-82% at 32; PERF.md).
_MIN_TILES_F32 = 8
# The short product's tiles are 128 rows and its query tiles 128-192
# queries, so a small scan (a probed partition: a few hundred queries over a
# few thousand rows) gets few units at 32 tiles a split; it splits rows down
# to 8 tiles, but into at most 32 splits: each split fills its own pools
# before the bound its splits share tightens, which cost more than the SMs
# gained at 128 splits of 8 tiles (64 queries over 131,072 rows; PERF.md,
# `scripts/torch_scan_ab.py --sweep`).
_MIN_TILES_SHORT = 8
_MAX_SPLITS_SHORT = 32
# The grid's last wave should be at least this full.
_WAVE_FILL = 0.9
# The plan's product codes (csrc/scan_topk.cu `Product`).
PRODUCTS = ("tile", "deep", "f32-fma", "short", "f32")
# (device, bf16, d, k, rows 16-byte aligned) -> Plan
_plans: dict = {}
# Columns a query of the sparse product takes.
COLUMNS_MAX = 16
# (device, width, k) -> ColumnPlan
_column_plans: dict = {}


class Plan(NamedTuple):
    """The library's launch plan for one (device, table type, d, k,
    alignment): product, queries and rows a tile, whether the query tile
    stays resident in shared memory, dynamic shared memory, blocks an SM
    holds, the SM count, pool entries per (query, split), and the int array
    the launch takes."""

    product: str
    tq: int
    tn: int
    resident: int
    smem: int
    bps: int
    sms: int
    pool: int
    raw: object

    @property
    def min_tiles(self) -> int:
        return {"f32-fma": _MIN_TILES_FMA, "f32": _MIN_TILES_F32,
                "short": _MIN_TILES_SHORT}.get(self.product, _MIN_TILES_PER_SPLIT)

    @property
    def max_splits(self) -> int:
        return _MAX_SPLITS_SHORT if self.product in ("short", "f32") else _MAX_POOL_WIDTH


class ColumnPlan(NamedTuple):
    """The library's plan of the sparse product for one (device, width, k):
    rows a stage, dynamic shared memory, packed column entries a query tile
    holds, blocks an SM holds, pool entries per (query, split), the SM
    count, and the int array the launch takes."""

    rows: int
    smem: int
    emax: int
    bps: int
    pool: int
    sms: int
    raw: object


def metric_code(metric) -> int:
    """0 = l2, 1 = dot, 2 = cos (scores over normalized storage)."""
    if isinstance(metric, str):
        metric = {"cos": Metric.COSINE}.get(metric) or Metric(metric)
    return _METRIC_CODES[metric.compute()]


def _check(q, x, xnorm2, k, code, mask):
    if k < 1:
        raise ValueError(f"scan_topk needs k >= 1, got k={k}")
    if q.dtype != torch.float32 or q.dim() != 2:
        raise ValueError(f"q must be [B, d] float32, got {tuple(q.shape)} {q.dtype}")
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 2:
        raise ValueError(f"x must be [N, d] float32 or bfloat16, got {x.dtype}")
    if x.shape[1] != q.shape[1]:
        raise ValueError(f"dim mismatch: q {tuple(q.shape)} vs x {tuple(x.shape)}")
    n = x.shape[0]
    tensors = [q, x]
    if code == 0:
        if xnorm2 is None or xnorm2.shape != (n,) or xnorm2.dtype != torch.float32:
            raise ValueError("l2 needs xnorm2 [N] float32")
        tensors.append(xnorm2)
    if mask is not None:
        if mask.shape != (n,) or mask.dtype not in (torch.bool, torch.uint8):
            raise ValueError("mask must be [N] bool or uint8")
        tensors.append(mask)
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("inputs must be contiguous")


def scan_topk(q, x, xnorm2, k: int, metric="l2", mask=None):
    """Top-k smallest scores of each query over the rows of x.

    q [B, d] f32; x [N, d] f32 or bf16; xnorm2 [N] f32 (l2 only; may be None
    otherwise); mask [N] bool/uint8 or None (False = row excluded). On the
    card each call also allocates the kernel's candidate pools (about 16 k
    bytes a query per row split, 1.25 KB at least), and for every product
    but the tile one |q|^2 (the short and f32 products also a shared bound
    per query), and the queries rounded to bf16 (short, deep) or split in
    two tf32 parts (f32).
    Returns sorted (d [B, k] f32, i [B, k] int32) with (+inf, -1) where fewer
    than k rows are eligible; ties go to the lower row id.
    """
    code = metric_code(metric)
    _check(q, x, xnorm2, k, code, mask)
    if q.device.type == "cpu":
        return scan_topk_reference(q, x, xnorm2, k, metric, mask)
    if q.device.type != "cuda":
        raise ValueError(f"scan_topk runs on cpu or cuda, not {q.device}")
    from vecgo_tpu_torch.kernels import _build

    lib = _build.library()
    b, d = q.shape
    n = x.shape[0]
    out_d = torch.empty((b, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((b, k), dtype=torch.int32, device=q.device)
    if b == 0:
        return out_d, out_i
    if n == 0:
        return out_d.fill_(math.inf), out_i.fill_(-1)
    bf16 = int(x.dtype == torch.bfloat16)
    plan = _plan(lib, q.device, bf16, d, k, int(x.data_ptr() % 16 == 0))
    tq = plan.tq
    splits, rows_per_split = split_plan(b, n, tq, plan.bps * plan.sms, plan.pool, plan.tn,
                                        plan.min_tiles, plan.max_splits)
    blocks = -(-b // tq) * splits

    def scratch(count, dtype=torch.float32):
        return torch.empty(count, dtype=dtype, device=q.device)

    qb = qn = None
    # 64-bit keys (score, row) and their counts
    pool = scratch(blocks * tq * plan.pool, torch.int64)
    pool_n = scratch(blocks * tq, torch.int32)
    if plan.product != "tile":
        # |q|^2; the short and f32 products keep each query's bound shared by
        # its splits behind it.
        qn = scratch(2 * b if plan.product in ("short", "f32") else b)
    if plan.product in ("deep", "short"):
        qb = scratch(b * (-(-d // 16) * 16), torch.bfloat16)
    elif plan.product == "f32":  # the queries' tf32 high and low parts
        qb = scratch(2 * b * (-(-d // 32) * 32))

    def ptr(t):
        return t.data_ptr() if t is not None else None

    with torch.cuda.device(q.device):  # the C launch uses the current device
        rc = lib.vecgo_scan_topk(
            q.data_ptr(), x.data_ptr(), ptr(xnorm2) if code == 0 else None, ptr(mask),
            b, n, d, k, code, rows_per_split, splits, ctypes.addressof(plan.raw), ptr(qb),
            ptr(qn), pool.data_ptr(), pool_n.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(rc, "scan_topk launch")
    scan_topk.launches += 1
    scan_topk.last_product = plan.product
    if plan.product == "f32":
        count_split_units(b, splits, tq)
    return out_d, out_i


scan_topk.launches = 0
scan_topk.last_product = None


def count_split_units(b: int, splits: int, tq: int) -> None:
    """Count a split f32 launch's units (`scan_topk.split_units`: query
    tiles of tq times splits) and those whose second consumer warpgroup has
    live queries (`scan_topk.split_paired_units`: the tile holds more than
    tq / 2 of the B queries), where a tracing recorder takes them."""
    from vecgo_tpu_torch.engine import tracing

    tracing.count("scan_topk.split_units", -(-b // tq) * splits)
    tracing.count("scan_topk.split_paired_units", (b // tq + (b % tq > tq // 2)) * splits)


def _plan(lib, device, bf16: int, d: int, k: int, aligned: int = 1) -> Plan:
    """The kernel's launch plan for this table, asked of the library once
    per (device, table type, d, k, whether the rows are 16-byte aligned)."""
    key = (device.index, bf16, d, k, aligned)
    if key not in _plans:
        from vecgo_tpu_torch.kernels import _build

        raw = (ctypes.c_int * 7)()
        with torch.cuda.device(device):
            rc = lib.vecgo_scan_topk_plan(bf16, d, k, aligned, ctypes.addressof(raw))
        _build.check(rc, "scan_topk plan")
        product, tq, tn, resident, smem, bps, pool = raw
        if bps < 1:
            raise RuntimeError(f"scan_topk: no block fits one SM (bf16={bf16}, d={d}, k={k})")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _plans[key] = Plan(PRODUCTS[product], tq, tn, resident, smem, bps, sms, pool, raw)
    return _plans[key]


def split_plan(b: int, n: int, tq: int, slots: int, pool: int, tn: int = _TN,
               min_tiles: int = _MIN_TILES_PER_SPLIT, max_splits: int = _MAX_POOL_WIDTH):
    """(splits, rows_per_split) for B queries in tiles of `tq` over N rows in
    tiles of `tn`, with `slots` blocks resident on the card at once and
    `pool` entries in each (query, split)'s candidate pool.

    Query tiles alone rarely fill the card (4096 queries are 64 tiles of
    64), so the rows are split too: the fewest splits whose grid fills its
    last wave to `_WAVE_FILL`, between one full wave and the most splits
    that keep `min_tiles` tiles each, at most `max_splits`, and the
    finishing kernel's reads (splits * pool) within `_MAX_POOL_WIDTH`.
    """
    q_tiles = -(-b // tq)
    n_tiles = -(-n // tn)
    s_max = max(1, min(n_tiles // min_tiles, _MAX_POOL_WIDTH // pool, max_splits))
    s_min = min(s_max, -(-slots // q_tiles))
    best, best_fill = s_min, 0.0
    for s in range(s_min, min(s_max, 8 * s_min) + 1):
        waves = q_tiles * s / slots
        fill = waves / math.ceil(waves)
        if fill > best_fill:
            best, best_fill = s, fill
        if fill >= _WAVE_FILL:
            break
    rows_per_split = -(-n_tiles // best) * tn
    return -(-n // rows_per_split), rows_per_split


def scan_topk_reference(q, x, xnorm2, k: int, metric="l2", mask=None):
    """Plain PyTorch version of `scan_topk`, blocked over N so it never holds
    the [B, N] score matrix. Same contract, same tie order."""
    code = metric_code(metric)
    b, n = q.shape[0], x.shape[0]
    dev = q.device
    qc = q.to(torch.bfloat16).float() if x.dtype == torch.bfloat16 else q
    qn = (q * q).sum(1, keepdim=True)
    best_d = torch.full((b, k), math.inf, dtype=torch.float32, device=dev)
    best_i = torch.full((b, k), -1, dtype=torch.int64, device=dev)
    block = max(_TN, _REF_BLOCK_ELEMS // max(b, 1))
    for s in range(0, n, block):
        e = min(n, s + block)
        prod = qc @ x[s:e].float().T
        if code == 0:
            sc = qn + xnorm2[s:e][None, :] - 2.0 * prod
        elif code == 1:
            sc = -prod
        else:
            sc = 1.0 - prod
        best_d, best_i = _merge_block(best_d, best_i, sc, s, mask, k)
    return _found(best_d, best_i)


def _merge_block(best_d, best_i, sc, s: int, mask, k: int):
    """The running top-k after the scores sc [B, e - s] of rows s .. e - 1:
    masked and non-finite scores excluded, ties to the lower id."""
    e = s + sc.shape[1]
    ok = torch.isfinite(sc)
    if mask is not None:
        ok &= mask[s:e].bool()[None, :]
    sc = torch.where(ok, sc, math.inf)
    ids = torch.arange(s, e, device=sc.device).expand(sc.shape[0], -1)
    # Stable sort: the running list (lower ids, already (d, id)-ordered)
    # precedes the block's rows in id order, so equal scores keep the
    # lower id first.
    cd, order = torch.sort(torch.cat([best_d, sc], 1), dim=1, stable=True)
    return cd[:, :k].contiguous(), torch.gather(torch.cat([best_i, ids], 1), 1, order[:, :k])


def _found(best_d, best_i):
    found = torch.isfinite(best_d)
    return (
        torch.where(found, best_d, math.inf),
        torch.where(found, best_i, -1).to(torch.int32),
    )


def _check_columns(cols, x, k, mask):
    if k < 1:
        raise ValueError(f"scan_topk_columns needs k >= 1, got k={k}")
    if cols.dim() != 2 or cols.dtype not in (torch.int32, torch.int64):
        raise ValueError(
            f"cols must be [B, T] int32 or int64, got {tuple(cols.shape)} {cols.dtype}")
    if cols.shape[1] > COLUMNS_MAX:
        raise ValueError(f"at most {COLUMNS_MAX} columns a query, got {cols.shape[1]}")
    if x.dtype != torch.bfloat16 or x.dim() != 2:
        raise ValueError(f"x must be [N, H] bfloat16, got {tuple(x.shape)} {x.dtype}")
    tensors = [cols, x]
    if mask is not None:
        if mask.shape != (x.shape[0],) or mask.dtype not in (torch.bool, torch.uint8):
            raise ValueError("mask must be [N] bool or uint8")
        tensors.append(mask)
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"all inputs must be on {x.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("inputs must be contiguous")


def scan_topk_columns(cols, x, k: int, mask=None):
    """Top-k of each query's sum of its own columns of each row: the device
    BM25 sweep. cols [B, T] int32 or int64, T <= 16, -1 pads (a repeated
    column counts each time); x [N, H] bf16; mask [N] bool/uint8 or None.

    The same function as `scan_topk(q, x, None, k, "dot", mask)` with q the
    multi-hot [B, H] query of cols (scatter-added counts), up to f32
    summation order: (d [B, k] f32 negated scores ascending, i [B, k] int32),
    ties to the lower row, (+inf, -1) past the live rows. On the card it
    also allocates the packed columns (2 T bytes a query), a bound and k
    shared best keys a query (8 + 8 k bytes) and the candidate pools (about
    16 k bytes a query per split of the rows: one split an SM). Columns
    outside [0, H) other than the pads raise on the CPU; the kernel reads
    them as pads.
    """
    _check_columns(cols, x, k, mask)
    if x.device.type == "cpu":
        return scan_topk_columns_reference(cols, x, k, mask)
    if x.device.type != "cuda":
        raise ValueError(f"scan_topk_columns runs on cpu or cuda, not {x.device}")
    from vecgo_tpu_torch.kernels import _build

    lib = _build.library()
    (b, t), (n, h) = cols.shape, x.shape
    dev = x.device
    out_d = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b == 0:
        return out_d, out_i
    if n == 0:
        return out_d.fill_(math.inf), out_i.fill_(-1)
    plan = _column_plan(lib, dev, h, k)
    splits = max(1, min(plan.bps * plan.sms, -(-n // plan.rows), _MAX_POOL_WIDTH // plan.pool))
    rows_per_split = -(-(-(-n // splits)) // plan.rows) * plan.rows
    splits = -(-n // rows_per_split)
    groups = -(-b // 32)

    def scratch(count, dtype):
        return torch.empty(count, dtype=dtype, device=dev)

    gstart = scratch(groups + 1, torch.int32)
    gcols = scratch(groups * 32 * max(t, 1), torch.int16)
    bound = scratch(b, torch.int64)
    best = scratch(b * k if splits >= k else 1, torch.int64)  # the splits' shared buckets
    pool = scratch(splits * b * plan.pool, torch.int64)
    pool_n = scratch(splits * b, torch.int32)
    with torch.cuda.device(dev):  # the C launch uses the current device
        rc = lib.vecgo_scan_columns(
            cols.data_ptr(), int(cols.dtype == torch.int64), b, t, x.data_ptr(),
            mask.data_ptr() if mask is not None else None, n, h, k, rows_per_split, splits,
            ctypes.addressof(plan.raw), gstart.data_ptr(), gcols.data_ptr(), bound.data_ptr(),
            best.data_ptr(), pool.data_ptr(), pool_n.data_ptr(),
            out_d.data_ptr(), out_i.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(rc, "scan_topk_columns launch")
    scan_topk.launches += 1
    scan_topk.last_product = "columns"
    return out_d, out_i


def _column_plan(lib, device, h: int, k: int) -> ColumnPlan:
    """The sparse product's launch plan, asked of the library once per
    (device, width, k)."""
    key = (device.index, h, k)
    if key not in _column_plans:
        from vecgo_tpu_torch.kernels import _build

        raw = (ctypes.c_int * 5)()
        with torch.cuda.device(device):
            rc = lib.vecgo_scan_columns_plan(h, k, ctypes.addressof(raw))
        _build.check(rc, f"scan_topk_columns plan (width {h}, k {k})")
        rows, smem, emax, bps, pool = raw
        if bps < 1:
            raise RuntimeError(f"scan_topk_columns: no block fits one SM (width {h}, k {k})")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _column_plans[key] = ColumnPlan(rows, smem, emax, bps, pool, sms, raw)
    return _column_plans[key]


def scan_topk_columns_reference(cols, x, k: int, mask=None):
    """Plain PyTorch version of `scan_topk_columns`, in blocks of rows: each
    query's columns in ascending order (the pads first, adding 0), the rows'
    weights at each gathered and added in f32 (the kernel's order, so its
    sums are these bit for bit), negated, masked, then the running top-k.
    Same contract, same tie order; it raises on a column outside [0, H)
    other than the -1 pads."""
    _check_columns(cols, x, k, mask)
    (b, t), (n, h) = cols.shape, x.shape
    c = cols.long()
    if c.numel() and (int(c.min()) < -1 or int(c.max()) >= h):
        raise ValueError(f"columns must lie in [0, {h}) or be -1")
    c = torch.sort(c, dim=1).values
    used, c = c >= 0, c.clamp_min(0)
    dev = x.device
    best_d = torch.full((b, k), math.inf, dtype=torch.float32, device=dev)
    best_i = torch.full((b, k), -1, dtype=torch.int64, device=dev)
    block = max(_TN, _REF_BLOCK_ELEMS // max(b, 1))
    for s in range(0, n, block):
        xs = x[s : min(n, s + block)]
        acc = torch.zeros((b, xs.shape[0]), dtype=torch.float32, device=dev)
        for j in range(t):
            acc += torch.where(used[:, j : j + 1], xs[:, c[:, j]].T.float(), 0.0)
        best_d, best_i = _merge_block(best_d, best_i, -acc, s, mask, k)
    return _found(best_d, best_i)
