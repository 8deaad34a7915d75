#!/usr/bin/env python3
"""Drive the PyTorch port's flat, graph, compact, quantized, streamed, cached,
beam-built, hybrid (BM25 + vector) and sharded (device grid) engine paths
once on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--profile]

1. Environment: card name and power limit, torch and CUDA versions, nvcc,
   Triton, and the seconds the kernels take to build from `vecgo_tpu_torch/csrc`
   (one nvcc per source, all started together).
2. Kernel phase: `scan_topk` against its plain PyTorch version on the card at
   the shapes the engine gives it (the segment scan at pools 18 and 82, f32
   memtable chunks at pools 74 and 82, wide rows), the short bf16 product at
   d 96 and at d 256 (its crossover to the deep product), plus k = 256, the deep
   bf16 shapes (262,144 x 3,072 at k 10; the dbpedia-openai-1M shape,
   1M x 1,536 cos, at k 100) and the f32 scan over 1M x 128 that
   ShardedFlat splits; each case prints the kernel product that ran (the
   cases of the deep and f32 products check that theirs did), its time
   beside its bound (the larger of operations over the card's peak for
   their type and bytes over 3.35 TB/s; for the split f32 product its three
   tf32 passes at 495 TFLOP/s, with the FMA units' fp32 bound beside it),
   its share of that bound, the JAX package's route in torch ops (a
   blockwise torch.mm with torch.topk and a running merge: a yardstick the
   port never calls) and the product alone through torch.mm (context only;
   for f32 tables IEEE fp32 with TF32 off, the f32 product's yardstick);
   then pools
   past 256: k = 1000 over the 1M-row segment and over one 131,072-row
   block, k = 4096 over 65,536 rows, and a memtable chunk (f32, 8,192 rows)
   at the pool of a k = 300 query (k 308) and at k = 1000; and the FMA f32
   product on memtable chunks TMA cannot read (a view that starts mid-row,
   and GloVe-50's 50-d rows). Every case runs the kernel's
   selection (unsorted candidate pools in a global scratch, compacted by
   radix selection, and a finishing kernel). Phase 5
   adds the same comparison on what its paths hand the kernel: a 131,072-row
   block of each quantizer's and each stream transport's codes, decoded to
   bf16, at that path's k (100, 20, 128) and mask, and one probed
   partition's rows for the queries that probe it.
3. Flat engine phase: Open -> insert_batch (1M clustered 128-d rows with
   metadata) -> commit -> 50k more rows left in the memtable -> 1,000
   deletes -> search_arrays over 4096-query batches, unfiltered and at
   1/10/80% selectivity (QPS: the median of five windows of at least 1 s),
   plus one search_arrays_stream pass; recall@10 against the exact
   plain-PyTorch answer over the visible rows, deleted ids absent, every live
   id readable by get, and the kernel's launch count; then k = 300 (a pool
   of 308 plus the churn margin): QPS beside recall@300 against the exact
   answer, and the wide-shape launches a batch.
4. Graph engine phase, on the same database: commit the memtable, compact
   every segment into one Vamana segment (~1.1M live rows), delete 1,000
   more ids and insert 10k more rows, then search_arrays at the serving
   profile (ef=48, nprobes=4, no refine, no rescore), with one refine round
   and the pool rescore, at 10% selectivity (brute force over the codes) and
   at 80% (the graph with a mask), and one search_arrays_stream pass; recall@10
   against the exact answer over the visible rows (floor 0.95), deleted ids
   absent, every live id readable, both kernels launched by the path, the
   segment's device_bytes() against what building its state allocates.
   Kernel B (`coded_group_scan`) is then held against its plain version on the
   segment's own table with the probe inversion of a real batch, at the
   serving profile (4 probes, kk 16), at 4 probes and kk 64 (two list entries
   a lane), at 4 probes and kk 96 and 256 (past the lists: pooled survivors)
   and at the segment's default knobs (20 probes, kk 8, qcap 96) with
   80% of the slots kept; each case prints its
   bound (probed clusters' bytes, bf16 peak) beside the all-clusters count
   (every cluster's bytes, fp32 peak: the count the first port used) and the
   code bytes' achieved TB/s.
   Then serve_compact: the segment's device state rebuilt from the
   one-slot-per-row table (S', its clusters' one-slot occupancy,
   device_bytes() against the overlap table's and the tensors'), the serving
   profile at twice its probes (8; recall floor 0.95), and kernel B at that
   shape against its plain version.

5. Quantized and beyond-device phase, over the flat phase's 1M rows:
   a. Open with quantizer="sq8" and flush_ivf_partitions=True -> insert_batch
      with metadata -> commit (128 partitions) -> 1,000 deletes ->
      search_arrays at refine_factor=10 unfiltered, at 10% selectivity and
      with nprobes=16 (recall floors 0.99, 0.99, 0.90); nprobes=128 returns
      the unprobed answer; deleted ids absent, live ids readable; the
      device state holds the codes only (allocated bytes against
      device_bytes()); the whole routed scan, full and probed, agrees rank
      by rank with the plain score-matrix route. Then the same rows in an
      engine with quantizer="pq" (m 16) at refine_factor=100: a pool of
      1,000 through the kernel, QPS and recall@10 (floor 0.99).
   b. INT4, PQ (m 16), OPQ (m 16, 3 iterations), BQ and RaBitQ at the segment
      level (FlatWriter -> FlatSegment.open -> search with a pool of 100 ->
      rerank): reranked recall@10 floors, train, encode and scan times, code
      bytes per vector, and the plain score-matrix route's time beside the
      scan_topk route's where both exist (the two pools agree rank by rank
      and rerank to the same recall; the plain route's pool of 1,000 recovers
      the true top 10); BQ's two Hamming scorers agree.
   c. The flat phase's unquantized 1M-row segment reopened (time travel)
      under a device budget below its size: flat_stream over the SQ8 and the
      PQ transport (recall floor 0.99, ids against the resident run and,
      where they differ, against the exact answer and a wider pool; the
      routed stream against the plain route; nothing resident, peak device
      memory against a block-sized bound, QPS beside the measured H2D rate
      of a pinned copy), and the PQ stream at k = 100 (a pool of 400); then
      the graph phase's database under a budget below its cluster cache's
      cache_bytes(): graph_stream, recall floor 0.99.

6. Cached tier: the graph phase's database reopened under a 64 MiB budget,
   which admits the cluster cache (cache_bytes(), ~37 MB) but not the
   segment (~859 MB): the planner plans graph_cached. Batches of 64 queries
   drawn around two of the generator's centres (one, if two drop probes):
   per batch the first run (its clusters admitted) and the warm rerun, QPS,
   hits / misses / dropped probes / uploaded bytes, recall@10 against the
   exact answer (floor 0.85 where no probe was dropped), the cache's device
   bytes against cache_bytes(); per batch the recall at ef 80 and at
   refine_factor 10 beside the defaults, and the share of the exact top-10
   among the cached scan's candidates at kk 8 (the JAX package's rule), 16
   (the port's) and 64; the first batch after release_cache() with
   the host table's encode timed apart; one 4096-query uniform batch
   (~3,000 probed clusters, past the cache's 256 slots: no probe dropped,
   recall@10 floor 0.99), first by route at the source level (the segment
   streamed as graph_stream streams it, and the cache scanned in chunks of
   clusters that fit), then through the engine with the route it takes;
   kernel B against its plain version
   on the cache tensors at kk 8 and kk 64. Then the same rows compacted with
   store_codes="sq8" and "pq" into a store that counts ranged reads and
   reopened from it: the store bytes a batch against the blob, the vectors
   never loaded while serving; recall@10 floor 0.85 on every run that
   dropped no probe, with the same recall by setting; the SQ8 table read
   from the store serves the rows of a fresh encode of the segment's rows,
   and PQ's recall is SQ8's within 0.05 (tests/test_ivf_cache.py's
   criteria).

7. Beam build and the writer-side tools: the flat phase's 1,048,576 rows
   compacted with graph_build_mode="beam" (build_graph, its table from
   build_ivf_table: K x 512, overlap 4), its build time, served at the
   engine's defaults (recall floor 0.95) and at the graph phase's serving
   profile, kernel B at the beam table's shape; FreshVamana over 65,536 of
   the rows (inserts, 35% soft deletes, consolidate; recall floor 0.85);
   `python -m vecgo_tpu_torch.tools.compact DIR --all` in a subprocess over
   a Local directory of 40,000 rows; vecgo_tpu_torch.entry.entry() on the
   card; and ingest rows/s (insert_batch's copy and finiteness check).

8. BM25 and hybrid search (bench.py's phase_hybrid at the smoke's scale):
   the flat phase's 1,048,576 rows with 12 zipf(1.3) words each over a
   20,000-word vocabulary, through insert_batch(texts=) with lexical=True
   (the per-row path; ingest rows/s, commit s); enable_device_lexical() at
   the JAX defaults (4096 hot terms, min_df 8: build s, H, device_bytes()
   against what it allocates); 4096-query batches of 3-word texts and
   vectors near the corpus: lexical-only QPS and the share of queries that
   take the rare merge; 256 queries held to the exact host index (hit
   counts, shared scores within 2e-2, and where ids differ, exact scores
   rank by rank within a bf16 near-tie; top-1 and overlap printed, mean
   overlap floor 0.7); hybrid_search_batch QPS through the snapshot with
   the lexical half's scan_topk launches; the exact host path
   (lexical_device="off") on 256 queries, held to hybrid_search on 32 (ids,
   RRF mass within 1e-6) and compared with the snapshot's batch; 1,000
   deletes and 1,000 inserts, after which the next batch rebuilds the
   snapshot by itself (timed), no deleted id is returned and a new doc is
   found by its term; then the sweep at its shape (B 4096, N 1,048,576,
   H 4096 bf16, the alive mask, k 36): `scan_topk_columns` (the lexical
   path's sweep, the "columns" product: the table read once, each query's
   own columns summed) against its plain version and against the dense
   function (scan_topk's plain version on the multi-hot query), its time
   beside its bound (the table's bytes), the plain version and the route;
   and the dense deep product at the same shape against its plain version
   ("hybrid-bm25-dense"), beside its dense bound.

9. The device grid (vecgo_tpu_torch.parallel), four shards laid over the
   cards present round-robin (cuda:0 four times on one card): ShardedFlat
   over the flat phase's 1,048,576 rows at L2 and cosine against the
   one-device scan_topk answer (ids up to ties, distances within 1e-4, QPS
   of both), db.sharded_searcher(grid) on the flat phase's database after
   its deletes (the exact one-device answer up to ties, no deleted id);
   after the graph phase, 8 updates, then ShardedEngineSearcher over its
   database (the coded segment through kernel B, the memtable through
   kernel A) at (dp 1, shard 4) and (dp 2, shard 2), refine_steps 0 and 2:
   recall@10 floor 0.95 against the exact visible answer, no deleted id,
   updated ids only at their new rows, both kernels launched; at the end
   sharded_kmeans_step over the 1M rows at 1,024 centres against a
   one-entry grid's, build_graph_clustered(mesh=) over the 1M rows against
   the one-device build (shape, no self-loop, degree >= 0.8x, beam recall
   within 0.05, both build times), entry.dryrun_multichip(4), and every
   example's main(device="cuda").

With --profile, the flat phase's unfiltered case, the graph phase's serving
case, the SQ8 engine path (unfiltered and probed), both streamed
transports, graph_stream, a warm graph_cached batch, a hybrid batch, the
grid's ShardedFlat (L2) and its engine plane (dp 1, shard 4, no refine)
also print a
breakdown of one sync batch: its wall time (the
median of 7 sync batches), the device's busy time in 3 batches under
torch.profiler (the union of kernel and copy intervals), the host's share
(wall - busy) and the largest device items.

Any failed check raises (exit code != 0). On success the last line is
{"ok": true, "device": {...}}. Without a CUDA device it exits with code 2.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time

import numpy as np
import torch

N = 1 << 20  # rows committed to the flat segment (sift-128-euclidean's scale)
DIM = 128
N_CLUSTERS = 1024
BATCH = 4096
K = 10
RECALL_FLOOR = 0.999
GRAPH_RECALL_FLOOR = 0.95
WIDE_K = 300  # a pool past 256 on the flat engine path
# Sync QPS: the median of QPS_WINDOWS windows of at least QPS_WINDOW_S each.
QPS_WINDOWS = 5
QPS_WINDOW_S = 1.0
# Two fp32 sums of the same products in different orders differ by a few ulp
# of the largest term: relative to |q|^2 + |x|^2, 2e-5 is ~170 ulp (fp32
# eps 1.2e-7), above the sqrt(d)-scaled rounding of a d <= 768 dot product.
REL_TOL = 2e-5
# Kernel B: relative to |q - c|^2 + |x^ - c|^2, the bound the CPU tests hold.
CODED_REL_TOL = 1e-4
# Published H100 SXM peaks at 700 W (NVIDIA data sheet): dense bf16 and
# tf32 on the tensor cores, fp32 on the FMA units, HBM3.
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
PEAK_F32 = 67e12
HBM_BPS = 3.35e12
# tf32 passes of the split f32 product (fp32-class accuracy: hi.hi + lo.hi +
# hi.lo).
SPLIT_PASSES = 3


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def clustered(rng, n: int, centers: np.ndarray) -> np.ndarray:
    """Rows around random cluster centres (bench.py's corpus generator)."""
    x = centers[rng.integers(0, len(centers), size=n)]
    return x + 0.35 * rng.standard_normal((n, centers.shape[1])).astype(np.float32)


def bound(flop: float, nbytes: float, bf16_tensor: bool, peak: float = 0.0):
    """The least time the H100 could take for this work (ms) and what bounds
    it: operations over the peak rate of their type (989 TFLOP/s bf16 dense
    on the tensor cores, 67 TFLOP/s fp32 on the FMA units, or `peak`)
    against bytes over 3.35 TB/s, each input read once and each output
    written once."""
    t_ops = flop / (peak or (PEAK_BF16 if bf16_tensor else PEAK_F32))
    t_mem = nbytes / HBM_BPS
    return (max(t_ops, t_mem) * 1e3, "operations" if t_ops >= t_mem else "bytes")


def route_ms(q, xs, xn, k, metric, mask) -> float:
    """The JAX package's own route for the same function, in torch ops: per
    131,072-row block one torch.mm (f32 sums: bf16 operands with an f32
    output where torch.mm takes out_dtype, else a bf16 output; f32 tables
    with TF32 off) and one torch.topk, merged into a running top-k by a
    second topk (vecgo_tpu/lexical/device_bm25.py `_scan_topk`,
    vecgo_tpu/ops/topk.py `blockwise_topk_scored`). A yardstick of two
    library calls a block, timed here and never called by the port."""
    from vecgo_tpu_torch.ops.scan_topk import metric_code

    code = metric_code(metric)
    qc = q.to(xs.dtype)
    qn = (q * q).sum(1, keepdim=True)
    n, block = xs.shape[0], 131072

    def product(blk):
        if xs.dtype == torch.bfloat16:
            try:
                return torch.mm(qc, blk.T, out_dtype=torch.float32)
            except TypeError:
                return torch.mm(qc, blk.T).float()
        return torch.mm(qc, blk.T)

    def run():
        best_d = best_i = None
        for s in range(0, n, block):
            e = min(n, s + block)
            prod = product(xs[s:e])
            sc = (qn + xn[s:e][None] - 2.0 * prod if code == 0 else
                  -prod if code == 1 else 1.0 - prod)
            if mask is not None:
                sc = torch.where(mask[s:e][None], sc, torch.inf)
            d, i = torch.topk(sc, min(k, e - s), dim=1, largest=False)
            i = i + s
            if best_d is not None:
                d, j = torch.topk(torch.cat([best_d, d], 1), k, dim=1, largest=False)
                i = torch.gather(torch.cat([best_i, i], 1), 1, j)
            best_d, best_i = d, i
        return best_d, best_i

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return cuda_ms(run, reps=2)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def mm_ms(q, xs) -> float:
    """The product alone through torch.mm on the same table in 64k-row
    blocks (context only: the port never calls it; no single PyTorch call
    computes the scan with its top-k); an f32 table's in IEEE fp32 (TF32
    off), the yardstick of the f32 product."""
    qc = q.to(xs.dtype)
    out = torch.empty((q.shape[0], 65536), dtype=xs.dtype, device=q.device)

    def run():
        for s in range(0, xs.shape[0], 65536):
            e = min(xs.shape[0], s + 65536)
            torch.mm(qc, xs[s:e].T, out=out[:, : e - s])

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return cuda_ms(run, reps=3)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def scan_case(name, q, xs, xn, k, metric, mask, card, note="", product=None):
    """`scan_topk` against its plain version on these tensors: the same +inf
    slots, distances within REL_TOL of |q|^2 + |x|^2, ids equal except where
    the kernel's row scores within twice that of the plain version's; then
    the kernel's time beside its bound, the plain version's time, the JAX
    route in torch ops (`route_ms`) and the product alone. q [B, d] f32, xs
    [N, d] bf16 or f32, xn [N] f32 (l2). `product`, where given, is the
    kernel product the plan must pick for this shape."""
    from vecgo_tpu_torch.ops.scan_topk import metric_code, scan_topk, scan_topk_reference

    code = metric_code(metric)
    (b, d), n = q.shape, xs.shape[0]
    args = (q, xs, xn, k, metric, mask)
    d_k, i_k = scan_topk(*args)
    ran = scan_topk.last_product
    check(product is None or ran == product, f"{name}: the {ran} product ran, not {product}")
    d_r, i_r = scan_topk_reference(*args)
    torch.cuda.synchronize()
    qn = (q * q).sum(1)
    tol = REL_TOL * float(qn.max() + xn.max()) if code == 0 else REL_TOL * 4
    check(torch.equal(torch.isfinite(d_k), torch.isfinite(d_r)), f"{name}: +inf slots differ")
    fin = torch.isfinite(d_r)
    err = float((d_k - d_r).abs()[fin].max())
    check(err <= tol, f"{name}: max |d_kernel - d_plain| = {err} > {tol}")
    # Ids may differ only where the kernel picked a row whose exact score
    # ties the plain version's within the tolerance.
    bad = (i_k != i_r) & fin
    if bad.any():
        bq, bj = bad.nonzero(as_tuple=True)
        rows = i_k[bq, bj].long()
        qq = q[bq].to(xs.dtype).double()
        xx = xs[rows].double()
        dot = (qq * xx).sum(1)
        exact = (qn[bq].double() + xn[rows].double() - 2 * dot, -dot, 1 - dot)[code]
        gap = float((exact - d_r[bq, bj].double()).abs().max())
        check(gap <= 2 * tol, f"{name}: {int(bad.sum())} ids differ beyond ties (gap {gap})")
    if mask is not None:
        check(bool(mask[i_k[fin].long()].all()), f"{name}: a masked row was returned")
    ms = cuda_ms(lambda: scan_topk(*args), reps=5)
    plain_ms = cuda_ms(lambda: scan_topk_reference(*args), reps=1)
    route = route_ms(*args)
    mm = mm_ms(q, xs)
    nbytes = (b * d * 4 + n * d * xs.element_size() + n * 4 * (code == 0)
              + (n if mask is not None else 0) + b * k * 8)
    bound_ms, bound_by = bound(2.0 * b * n * d, nbytes, xs.dtype == torch.bfloat16)
    extra = {}
    if ran == "f32":
        # The split product's bound: the tf32 passes fp32-class accuracy
        # needs on the tensor cores; the FMA units' fp32 bound beside it.
        extra["fma_bound_ms"] = bound_ms
        bound_ms, bound_by = bound(SPLIT_PASSES * 2.0 * b * n * d, nbytes, False, PEAK_TF32)
    print(f"kernel {name}: B={b} N={n} d={d} k={k} {str(xs.dtype)[6:]} {('l2', 'dot', 'cos')[code]}"
          f"{note}: {ran} product {ms:.3f} ms, "
          f"bound {bound_ms:.3f} ms ({bound_by}), share {bound_ms / ms:.1%}, "
          + (f"fp32 FMA bound {extra['fma_bound_ms']:.3f} ms "
             f"({extra['fma_bound_ms'] / ms:.1%}), " if extra else "") +
          f"plain {plain_ms:.3f} ms, route (torch.mm + torch.topk) {route:.3f} ms, "
          f"torch.mm product alone {mm:.3f} ms, "
          f"max_abs_err {err:.3g} (tol {tol:.3g}), tie swaps {int(bad.sum())} [{card}]",
          flush=True)
    return {"name": name, "product": ran, "err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "share": bound_ms / ms,
            "route_ms": route, "mm_ms": mm, **extra}


def kernel_case(name, rng, b, n, d, k, dtype, metric, mask_frac, card, product=None,
                on_device=False, offset=0):
    """`scan_case` on clustered rows made here: with numpy, or (on_device,
    for the large deep-d tables) with a CUDA generator seeded from rng; with
    `offset`, the table is a view that starts that many elements into its
    buffer."""
    dev = torch.device("cuda")
    if on_device:
        g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 62)))
        centers = torch.randn((N_CLUSTERS, d), generator=g, device=dev)

        def made(rows):
            pick = torch.randint(0, N_CLUSTERS, (rows,), generator=g, device=dev)
            return centers[pick] + 0.35 * torch.randn((rows, d), generator=g, device=dev)

        x, q = made(n), made(b)
    else:
        centers = rng.standard_normal((N_CLUSTERS, d)).astype(np.float32)
        x = torch.from_numpy(clustered(rng, n, centers)).to(dev)
        q = torch.from_numpy(clustered(rng, b, centers)).to(dev)
    if metric == "cos":
        x = x / x.norm(dim=1, keepdim=True)
        q = q / q.norm(dim=1, keepdim=True)
    xn = (x * x).sum(1)
    xs = x.to(dtype).contiguous()
    del x
    if offset:
        buf = torch.empty(n * d + offset, dtype=dtype, device=dev)
        buf[offset:].view(n, d).copy_(xs)
        xs = buf[offset:].view(n, d)
    mask = None
    if mask_frac:
        mask = torch.from_numpy(rng.random(n) >= mask_frac).to(dev)
    note = (f" mask {mask_frac:.0%} out" if mask_frac else "") + (
        f" view +{offset}" if offset else "")
    return scan_case(name, q, xs, xn, k, metric, mask, card, note, product)


def path_block_case(name, quant, metric, q, blk, k, mask, card, note=""):
    """`scan_case` on what `ops/topk.BlockScanner` hands the kernel for one
    block of a quantizer's codes: the transformed query batch and the block
    decoded to its transient bf16 table, at the path's own k and mask."""
    qp, _, kmetric = quant.scan_form(q, metric)
    table, rn = quant.scan_table(blk)
    return scan_case(name, qp, table.contiguous(), rn.contiguous(), k, kmetric, mask, card, note)


def routes_agree(name, q, rn, routed, plain):
    """Hold a whole routed scan (d, rows) against the plain score-matrix
    route's on the same inputs. Both sum the same bf16 products in another
    order, so the sorted distances agree at every rank within REL_TOL of
    |q|^2 + |x^|^2 (rn: the decoded rows' norms); rows may differ only
    there, at ties. Returns (largest gap, tolerance, rows that differ)."""
    (d_r, i_r), (d_p, i_p) = routed, plain
    tol = REL_TOL * float((q * q).sum(1).max() + rn.max())
    check(torch.equal(torch.isfinite(d_r), torch.isfinite(d_p)), f"{name}: +inf slots differ")
    fin = torch.isfinite(d_p)
    gap = float((d_r - d_p).abs()[fin].max())
    check(gap <= tol, f"{name}: routed and plain distances differ by {gap} > {tol}")
    return gap, tol, int(((i_r != i_p) & fin).sum())


def window_qps(run, n) -> float:
    """QPS of back-to-back calls of `run` (n queries each) over one window
    of QPS_WINDOW_S."""
    t0 = time.perf_counter()
    done = 0
    while (elapsed := time.perf_counter() - t0) < QPS_WINDOW_S:
        run()
        done += n
    return done / elapsed


def sync_qps(db, queries, kw, k=K) -> float:
    """QPS of back-to-back search_arrays calls over one window of QPS_WINDOW_S."""
    return window_qps(lambda: db.search_arrays(queries, k=k, **kw), len(queries))


def profile_batch(db, queries, kw, label, card, reps=3, run=None):
    """Where one sync search_arrays batch (or one call of `run`) spends its
    time: wall (median of 7 sync batches), device busy (the union of the
    kernel and copy intervals that torch.profiler records over `reps`
    batches, per batch), the rest (host work and idle device), and the
    largest device items."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def batch():
        if run is None:
            db.search_arrays(queries, k=K, **kw)
        else:
            run()
        torch.cuda.synchronize()

    walls = []
    for _ in range(7):
        t0 = time.perf_counter()
        batch()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = sorted(walls)[3]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            batch()
    spans, items = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        t = e.time_range
        spans.append((t.start, t.end))
        name = e.name if len(e.name) <= 48 else e.name[:45] + "..."
        us, calls = items.get(name, (0.0, 0))
        items[name] = (us + t.end - t.start, calls + 1)
    check(bool(spans), f"profile {label}: the profiler recorded device work")
    busy_us, end = 0.0, -np.inf
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    busy = busy_us / 1e3 / reps
    top = sorted(items.items(), key=lambda kv: -kv[1][0])[:6]
    print(f"profile {label}: wall {wall:.3f} ms/batch (median of 7 sync batches), device busy "
          f"{busy:.3f} ms ({busy / wall:.1%}), host and idle {wall - busy:.3f} ms "
          f"({1 - busy / wall:.1%}); largest device items per batch: "
          + "; ".join(f"{n} {us / 1e3 / reps:.3f} ms ({c / reps:g} calls)"
                      for n, (us, c) in top) + f" [{card}]", flush=True)


def engine_phase(args, card):
    import vecgo_tpu_torch as vg
    from vecgo_tpu_torch.metadata import isin
    from vecgo_tpu_torch.ops.scan_topk import scan_topk, scan_topk_reference

    rng = np.random.default_rng(args.seed)
    centers = rng.standard_normal((N_CLUSTERS, DIM)).astype(np.float32)
    x1 = clustered(rng, N, centers)
    x2 = clustered(rng, 50_000, centers)
    u1 = rng.integers(0, 100, N)
    u2 = rng.integers(0, 100, len(x2))
    queries = [clustered(rng, BATCH, centers) for _ in range(4)]
    metas1 = [{"u": int(v)} for v in u1]
    metas2 = [{"u": int(v)} for v in u2]

    scan_topk.launches = 0
    backend = vg.Memory()
    db = vg.Open(backend, vg.Create(dim=DIM, flush_threshold=2**62), device="cuda")
    t0 = time.perf_counter()
    ids1 = np.asarray(db.insert_batch(x1, metas1), np.int64)
    ingest_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    flat_version = db.commit()
    commit_s = time.perf_counter() - t0
    ids2 = np.asarray(db.insert_batch(x2, metas2), np.int64)
    all_ids = np.concatenate([ids1, ids2])
    deleted = rng.choice(all_ids, 1000, replace=False)
    for i in deleted:
        check(db.delete(int(i)), f"delete {i}")
    print(f"engine ingest: {N} rows in {ingest_s:.3f} s = {N / ingest_s:.0f} rows/s; "
          f"commit {commit_s:.3f} s [{card}]", flush=True)

    dev = torch.device("cuda")
    x_all = torch.from_numpy(np.concatenate([x1, x2])).to(dev)
    xn_all = (x_all * x_all).sum(1)
    u_all = np.concatenate([u1, u2])
    live = ~np.isin(all_ids, deleted)
    q0 = torch.from_numpy(queries[0]).to(dev)
    results = {}
    for name, sel in (("unfiltered", None), ("sel1", 1), ("sel10", 10), ("sel80", 80)):
        kw = {} if sel is None else {"filter": isin("u", list(range(sel)))}
        vis = live if sel is None else live & (u_all < sel)
        _, gt_rows = scan_topk_reference(q0, x_all, xn_all, K, "l2",
                                         torch.from_numpy(vis).to(dev))
        gt = all_ids[gt_rows.cpu().numpy()]
        got, dist = db.search_arrays(queries[0], k=K, **kw)
        check(got.shape == (BATCH, K) and np.isfinite(dist).all(), f"{name}: result shape/finite")
        check(not np.isin(got, deleted).any(), f"{name}: a deleted id was returned")
        recall = np.mean([len(set(g) & set(t)) / K for g, t in zip(got, gt)])
        windows = sorted(sync_qps(db, queries[0], kw) for _ in range(QPS_WINDOWS))
        qps = windows[len(windows) // 2]
        results[name] = (qps, recall)
        print(f"engine search_arrays {name}: {qps:.0f} QPS (B={BATCH}; median of "
              f"{QPS_WINDOWS} windows >= {QPS_WINDOW_S} s, range {windows[0]:.0f}-"
              f"{windows[-1]:.0f}), recall@10 {recall:.5f} [{card}]", flush=True)
        check(recall >= RECALL_FLOOR, f"{name}: recall {recall} < {RECALL_FLOOR}")
        if args.profile and sel is None:
            profile_batch(db, queries[0], kw, "flat unfiltered", card)

    # A pool past 256: k = 300 on the segment (pool 308 plus the churn
    # margin) and the memtable, through the kernel.
    _, gt_rows = scan_topk_reference(q0, x_all, xn_all, WIDE_K, "l2", torch.from_numpy(live).to(dev))
    gt = all_ids[gt_rows.cpu().numpy()]
    launches_before = scan_topk.launches
    got, dist = db.search_arrays(queries[0], k=WIDE_K)
    k300_launches = scan_topk.launches - launches_before
    check(k300_launches > 0, "k300: the batch went through the kernel")
    check(got.shape == (BATCH, WIDE_K) and np.isfinite(dist).all(), "k300: result shape/finite")
    check(not np.isin(got, deleted).any(), "k300: a deleted id was returned")
    recall = np.mean([len(set(g) & set(t)) / WIDE_K for g, t in zip(got, gt)])
    qps, lo, hi = median_qps(db, queries[0], {}, k=WIDE_K)
    print(f"engine search_arrays k={WIDE_K}: {qps:.0f} QPS (B={BATCH}; median of {TIER_WINDOWS} "
          f"windows, range {lo:.0f}-{hi:.0f}), recall@{WIDE_K} {recall:.5f}, "
          f"scan_topk launches a batch {k300_launches} [{card}]", flush=True)
    check(recall >= RECALL_FLOOR, f"k300: recall {recall} < {RECALL_FLOOR}")
    del gt_rows, gt

    t0 = time.perf_counter()
    streamed = list(db.search_arrays_stream(iter(queries), k=K, depth=3))
    stream_s = time.perf_counter() - t0
    check(len(streamed) == 4, "stream yielded 4 batches")
    for qb, (ids_s, _) in zip(queries, streamed):
        ids_b, _ = db.search_arrays(qb, k=K)
        check(np.array_equal(ids_s, ids_b), "stream results equal search_arrays")
        check(not np.isin(ids_s, deleted).any(), "stream: a deleted id was returned")
    print(f"engine search_arrays_stream: 4 x {BATCH} queries, "
          f"{4 * BATCH / stream_s:.0f} QPS [{card}]", flush=True)

    t0 = time.perf_counter()
    for i in all_ids[live]:
        db.get(int(i))
    for i in deleted:
        try:
            db.get(int(i))
        except vg.ErrNotFound:
            continue
        raise RuntimeError(f"check failed: deleted id {i} still readable")
    print(f"engine get: {int(live.sum())} live ids readable, 1000 deleted ids gone "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    launches = scan_topk.launches
    check(launches > 0, "the engine path launched scan_topk")
    print(f"engine peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"scan_topk launches {launches} [{card}]", flush=True)
    return {"db": db, "rng": rng, "centers": centers, "queries": queries, "x_all": x_all,
            "ids": all_ids, "u": u_all, "deleted": deleted, "launches": launches,
            "profile": args.profile, "backend": backend, "flat_version": flat_version,
            "x1": x1, "u1": u1, "metas1": metas1}


def exact_ids(q, x_all, visible, all_ids) -> np.ndarray:
    """The ids of the exact plain-PyTorch top-K over the visible rows."""
    from vecgo_tpu_torch.ops.scan_topk import scan_topk_reference

    xn = (x_all * x_all).sum(1)
    _, rows = scan_topk_reference(q, x_all, xn, K, "l2",
                                  torch.from_numpy(visible).to(x_all.device))
    return all_ids[rows.cpu().numpy()]


def recall_of(got, gt) -> float:
    """The share of each row of `gt` found in the same row of `got`."""
    return float(np.mean([len(set(g) & set(t)) / len(t) for g, t in zip(got, gt)]))


def recall_vs_exact(got, q, x_all, visible, all_ids) -> float:
    """Recall@K of `got` against the exact plain-PyTorch answer over the
    visible rows."""
    return recall_of(got, exact_ids(q, x_all, visible, all_ids))


def graph_phase(st, card):
    """Compact the flat phase's database into one Vamana segment and serve it."""
    import gc

    import vecgo_tpu_torch as vg
    from vecgo_tpu_torch.metadata import isin
    from vecgo_tpu_torch.index.vamana import VamanaSegment
    from vecgo_tpu_torch.ops.coded_group_scan import coded_group_scan
    from vecgo_tpu_torch.ops.scan_topk import scan_topk

    db, rng, queries = st["db"], st["rng"], st["queries"]
    dev = torch.device("cuda")
    scan_topk.launches = 0
    coded_group_scan.launches = 0
    torch.cuda.reset_peak_memory_stats()
    db.commit()
    t0 = time.perf_counter()
    db.compact([h.seg_id for h in db.engine._segments])
    compact_s = time.perf_counter() - t0
    segs = [h.segment for h in db.engine._segments]
    check(len(segs) == 1 and type(segs[0]) is VamanaSegment,
          f"compaction wrote one vecgo_tpu_torch VamanaSegment, got {[type(x) for x in segs]}")
    seg = segs[0]
    print(f"graph compact: {seg.n} live rows into one {type(seg).__module__}."
          f"{type(seg).__name__} (IVF membership {tuple(seg.ivf_members.shape)}) in "
          f"{compact_s:.3f} s; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB [{card}]", flush=True)

    all_ids, deleted, u_all = st["ids"], st["deleted"], st["u"]
    more = rng.choice(all_ids[~np.isin(all_ids, deleted)], 1000, replace=False)
    for i in more:
        check(db.delete(int(i)), f"delete {i}")
    x3 = clustered(rng, 10_000, st["centers"])
    u3 = rng.integers(0, 100, len(x3))
    ids3 = np.asarray(db.insert_batch(x3, [{"u": int(v)} for v in u3]), np.int64)
    all_ids = np.concatenate([all_ids, ids3])
    deleted = np.concatenate([deleted, more])
    u_all = np.concatenate([u_all, u3])
    x_all = torch.cat([st["x_all"], torch.from_numpy(x3).to(dev)])
    live = ~np.isin(all_ids, deleted)
    q0 = torch.from_numpy(queries[0]).to(dev)

    serving = dict(ef=48, nprobes=4, graph_refine=0, graph_rescore=False)
    refine = dict(ef=48, nprobes=4)  # one refine round and the int16 pool rescore
    results = {}
    for name, kw, sel in (("serving", serving, None), ("refine", refine, None),
                          ("sel10", refine, 10), ("sel80", refine, 80)):
        if sel is not None:
            kw = dict(kw, filter=isin("u", list(range(sel))))
        vis = live if sel is None else live & (u_all < sel)
        got, dist = db.search_arrays(queries[0], k=K, **kw)
        check(got.shape == (BATCH, K) and np.isfinite(dist).all(),
              f"graph {name}: result shape/finite")
        check(not np.isin(got, deleted).any(), f"graph {name}: a deleted id was returned")
        recall = recall_vs_exact(got, q0, x_all, vis, all_ids)
        windows = sorted(sync_qps(db, queries[0], kw) for _ in range(QPS_WINDOWS))
        qps = windows[len(windows) // 2]
        results[name] = (qps, recall)
        plan = {"serving": "graph, refine 0, no rescore", "refine": "graph, refine 1, rescore",
                "sel10": "brute_masked over the codes",
                "sel80": "graph with a mask, refine 1, rescore"}[name]
        print(f"graph search_arrays {name} ({plan}): {qps:.0f} QPS (B={BATCH}; median of "
              f"{QPS_WINDOWS} windows >= {QPS_WINDOW_S} s, range {windows[0]:.0f}-"
              f"{windows[-1]:.0f}), recall@10 {recall:.5f} [{card}]", flush=True)
        check(recall >= GRAPH_RECALL_FLOOR, f"graph {name}: recall {recall} < {GRAPH_RECALL_FLOOR}")
        if st["profile"] and name == "serving":
            profile_batch(db, queries[0], kw, "graph serving", card)

    t0 = time.perf_counter()
    streamed = list(db.search_arrays_stream(iter(queries), k=K, depth=3, **serving))
    stream_s = time.perf_counter() - t0
    check(len(streamed) == 4, "graph stream yielded 4 batches")
    for qb, (ids_s, _) in zip(queries, streamed):
        ids_b, _ = db.search_arrays(qb, k=K, **serving)
        check(np.array_equal(ids_s, ids_b), "graph stream results equal search_arrays")
        check(not np.isin(ids_s, deleted).any(), "graph stream: a deleted id was returned")
    recall = recall_vs_exact(streamed[0][0], q0, x_all, live, all_ids)
    check(recall >= GRAPH_RECALL_FLOOR, f"graph stream: recall {recall}")
    print(f"graph search_arrays_stream (serving profile): 4 x {BATCH} queries, "
          f"{4 * BATCH / stream_s:.0f} QPS, recall@10 {recall:.5f} [{card}]", flush=True)

    t0 = time.perf_counter()
    for i in all_ids[live]:
        db.get(int(i))
    for i in deleted:
        try:
            db.get(int(i))
        except vg.ErrNotFound:
            continue
        raise RuntimeError(f"check failed: deleted id {i} still readable")
    print(f"graph get: {int(live.sum())} live ids readable, {len(deleted)} deleted ids gone "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    launches = {"scan_topk": scan_topk.launches, "coded_group_scan": coded_group_scan.launches}
    for name, n in launches.items():
        check(n > 0, f"the graph path launched {name}")
    print(f"graph peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"launches {launches} [{card}]", flush=True)
    # The planner admits a graph segment by device_bytes(): hold it against
    # what the device state takes, by its tensors' sizes and by the allocator
    # (the state is dropped and built again between two readings).
    state = seg.device_state(dev)
    held = sum(t.numel() * t.element_size()
               for t in (state["graph"], *state["ivfq"]) if t is not None)
    del state
    seg.release_device()
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    seg.device_state(dev)
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - before
    want = seg.device_bytes()
    print(f"graph device state: device_bytes() {want}, its tensors {held} bytes, allocated by "
          f"building it {grown} bytes [{card}]", flush=True)
    check(abs(held - want) <= want // 100, f"device_bytes() {want} against {held} bytes of tensors")
    check(abs(grown - want) <= want // 100, f"device_bytes() {want} against {grown} allocated")
    st.update(graph_ids=all_ids, graph_deleted=deleted, graph_x=x_all, graph_u=u_all,
              graph_serving_qps=results["serving"][0])
    return seg, launches


# Kernel B's cases: (name, probes, kk, share of slots kept): the serving
# profile, the same at kk 64 (two list entries a lane) and at kk 96 and 256
# (past the lists: pooled survivors), and the segment's default knobs (ef 80
# -> 20 probes, kk 8) under an 80% filter.
CODED_CASES = (("serving", 4, 16, 1.0), ("serving-kk64", 4, 64, 1.0),
               ("serving-kk96", 4, 96, 1.0), ("serving-kk256", 4, 256, 1.0),
               ("probes20", 20, 8, 0.8))


def coded_inputs(t, q, rng, n_probe, kk, keep):
    """Kernel B's arguments for a query batch q on a coded table t: the
    probe inversion of the batch at `n_probe` probes and the default qcap;
    `keep` < 1 masks the other slots in bn (+inf). Returns (args, qcap)."""
    from vecgo_tpu_torch.ops import ivf as ivf_ops
    from vecgo_tpu_torch.ops.topk import topk_smallest

    k_pad, s = t.bnorm2.shape
    b = q.shape[0]
    cd = (q * q).sum(1)[:, None] + t.cnorm2[None, :] - 2.0 * (
        q.to(torch.bfloat16).float() @ t.centroids.to(torch.bfloat16).float().T)
    _, probes = topk_smallest(cd, n_probe)
    qcap = ivf_ops.default_qcap(b, n_probe, k_pad)
    qtab, _ = ivf_ops._invert_probes(probes, k_pad, qcap)
    bn = t.bnorm2
    if keep < 1:
        kept = torch.from_numpy(rng.random((k_pad, s)) < keep).to(q.device)
        bn = torch.where(kept, bn, torch.inf).contiguous()
    return (q, qtab, t.codes, bn, t.scale, t.centroids, kk), qcap


def coded_check(name, args, out, ref):
    """Hold kernel B's output (d, i) against its plain version's: the same
    +inf slots, distances within CODED_REL_TOL of |q - c|^2 + max bn, and
    ids equal except where the kernel's column scores within twice that of
    the plain version's. Returns (max |d - plain|, tolerance, tie swaps)."""
    q, qtab, codes, bn, scale, cent, _ = args
    (d_k, i_k), (d_r, _) = out, ref
    b = q.shape[0]
    live = qtab < b
    qr = q[qtab.clamp_max(b - 1).long()] - cent[:, None, :]  # [K, qcap, d]
    qrn = torch.where(live, (qr * qr).sum(-1), 0.0)
    bn_max = bn[torch.isfinite(bn)].max()
    # Both sides sum exact bf16 x int8 products in f32 in another order.
    tol = CODED_REL_TOL * float(qrn.max() + bn_max)
    check(torch.equal(torch.isfinite(d_k), torch.isfinite(d_r)), f"{name}: +inf slots differ")
    fin = torch.isfinite(d_r)
    err = float((d_k - d_r).abs()[fin].max())
    check(err <= tol, f"{name}: max |d_kernel - d_plain| = {err} > {tol}")
    bad = (i_k != ref[1]) & fin
    n_bad = int(bad.sum())
    if n_bad:
        c, j, _ = bad.nonzero(as_tuple=True)
        col = i_k[bad].long()
        v = qr[c, j].to(torch.bfloat16).double()
        exact = (qrn[c, j].double() + bn[c, col].double()
                 - 2.0 * scale[c].double() * (v * codes[c, col].double()).sum(1))
        gap = float((exact - d_r[bad].double()).abs().max())
        check(gap <= 2 * tol, f"{name}: {n_bad} columns differ beyond ties (gap {gap})")
    return err, tol, n_bad


def coded_case(seg, q_np, rng, name, n_probe, kk, keep, card):
    """Kernel B against its plain version on the segment's own table, with
    the probe inversion of a real 4096-query batch (`coded_inputs`)."""
    dev = torch.device("cuda")
    t = seg.device_state(dev)["ivfq"]
    args, qcap = coded_inputs(t, torch.from_numpy(q_np).to(dev), rng, n_probe, kk, keep)
    return coded_measure(name, args, qcap, n_probe, keep, card)


def coded_measure(name, args, qcap, n_probe, keep, card, note=""):
    """Kernel B against its plain version on these arguments (`coded_check`),
    then its time beside its bound, the all-clusters count and the plain
    version's time."""
    from vecgo_tpu_torch.ops.coded_group_scan import (
        coded_group_scan, coded_group_scan_reference)

    q, qtab, codes, bn, scale, cent, kk = args
    k_pad, s, d = codes.shape
    b = q.shape[0]
    d_k, i_k = coded_group_scan(*args)
    ref = coded_group_scan_reference(*args)
    torch.cuda.synchronize()
    err, tol, n_bad = coded_check(name, args, (d_k, i_k), ref)
    live = qtab < b
    ms = cuda_ms(lambda: coded_group_scan(*args), reps=20)
    plain_ms = cuda_ms(lambda: coded_group_scan_reference(*args), reps=2)
    # Work this batch needs: each live (cluster, query) pair scores the
    # cluster's valid slots (finite bn: a row, not filtered out) at d, bf16 x
    # int8 products that are exact in bf16 (the tensor cores' bf16 peak);
    # bytes: the valid slots' codes and norms and the scale and centroid of
    # each probed cluster once (an unprobed cluster needs none), the queries
    # and the probe table once, the outputs once.
    n_live = int(live.sum())
    probed_m = live.any(1)
    probed = int(probed_m.sum())
    occ = torch.isfinite(bn).sum(1)
    valid_probed = int(occ[probed_m].sum())
    pair_slots = int((live.sum(1) * occ).sum())
    out_bytes = d_k.numel() * 4 + i_k.numel() * 4
    fixed = probed * (4 + d * 4) + q.numel() * 4 + qtab.numel() * 4 + out_bytes
    bound_ms, bound_by = bound(2.0 * pair_slots * d, valid_probed * (d + 4) + fixed, True)
    # Every slot of each probed cluster, padding included (what the kernel
    # reads: it scans all S).
    code_bytes = probed * s * d
    slots_ms, slots_by = bound(2.0 * n_live * s * d, code_bytes + probed * s * 4 + fixed, True)
    # The all-clusters count, for comparison with earlier records: every
    # cluster's codes and norms, fp32 peak.
    old_bytes = (codes.numel() + bn.numel() * 4 + scale.numel() * 4
                 + cent.numel() * 4 + q.numel() * 4 + qtab.numel() * 4 + out_bytes)
    old_ms, old_by = bound(2.0 * n_live * s * d, old_bytes, False)
    per = torch.bincount(live.sum(1))
    print(f"kernel coded_group_scan {name}: B={b} K={k_pad} S={s} d={d} qcap={qcap} kk={kk} "
          f"probes={n_probe}{f' slots kept {keep:.0%}' if keep < 1 else ''}{note} ({n_live} live "
          f"(cluster, query) pairs over {probed} probed clusters, at most "
          f"{per.shape[0] - 1} a cluster; {valid_probed} valid slots in the probed clusters, "
          f"{valid_probed / max(1, probed * s):.1%} of their slots): kernel {ms:.3f} ms, bound "
          f"{bound_ms:.3f} ms ({bound_by}), share {bound_ms / ms:.1%}; all-slots bound "
          f"{slots_ms:.3f} ms ({slots_by}), share {slots_ms / ms:.1%}; all-clusters bound "
          f"{old_ms:.3f} ms ({old_by}), share {old_ms / ms:.1%}; codes read (every slot) "
          f"{code_bytes / 1e6:.1f} MB at {code_bytes / (ms * 1e-3) / 1e12:.3f} TB/s; plain {plain_ms:.3f} ms, max_abs_err "
          f"{err:.3g} (tol {tol:.3g}), tie swaps {n_bad} [{card}]", flush=True)
    return {"name": name, "err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bound_ms_all_slots": slots_ms,
            "bound_ms_all_clusters": old_ms, "code_tbps":
            code_bytes / (ms * 1e-3) / 1e12}


# The overlap table's device bytes at graph-1.1M-churn (PERF.md, section 6).
OVERLAP_DEVICE_BYTES = 858_650_528


def compact_phase(st, seg, rng, card):
    """Phase 4b: the graph phase's segment served from the one-slot-per-row
    table (serve_compact): its device state rebuilt, S' and device_bytes()
    against the overlap table's and the tensors', the serving profile at
    twice its probes (recall floor 0.95), and kernel B at the compact shape.
    Returns both kernels' launches on this path and kernel B's case."""
    import gc

    from vecgo_tpu_torch.ops.coded_group_scan import coded_group_scan
    from vecgo_tpu_torch.ops.scan_topk import scan_topk

    dev = torch.device("cuda")
    db, queries = st["db"], st["queries"]
    overlap_bytes = seg.device_bytes()
    seg.release_device()
    gc.collect()
    seg.serve_compact = True
    upper = seg.device_bytes()
    scan_topk.launches = coded_group_scan.launches = 0
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    state = seg.device_state(dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    grown = torch.cuda.memory_allocated() - before
    t = state["ivfq"]
    k_pad, s2 = t.rows.shape
    held = sum(x.numel() * x.element_size() for x in (state["graph"], *t) if x is not None)
    want = seg.device_bytes()
    slots = int((t.rows >= 0).sum())
    # S' follows the fullest cluster's one-slot count, not the average.
    occ = np.sort((t.rows >= 0).sum(1).cpu().numpy())[::-1]
    print(f"compact table: K={k_pad} S'={s2} (the overlap table's S "
          f"{seg.ivf_members.shape[1]}), {slots} slots for {seg.n} rows (one-slot occupancy: max "
          f"{occ[0]}, 10th largest {occ[9]}, 99th percentile {np.percentile(occ, 99):.0f}, median "
          f"{np.median(occ):.0f}; {int((occ > s2 - 128).sum())} clusters above {s2 - 128}), "
          f"built in {build_s:.3f} s; "
          f"device_bytes() {want} against the overlap table's {overlap_bytes} "
          f"({want / overlap_bytes:.3f}; graph-1.1M-churn's {OVERLAP_DEVICE_BYTES}); before the "
          f"build {upper}; its tensors {held} bytes, allocated {grown} [{card}]", flush=True)
    check(slots == seg.n and s2 % 128 == 0 and s2 <= seg.ivf_members.shape[1],
          "one slot per row, S' a multiple of 128 up to S")
    check(upper == overlap_bytes and abs(held - want) <= want // 100 and want <= overlap_bytes,
          "compact device_bytes()")
    del state, t
    all_ids, deleted, x_all = st["graph_ids"], st["graph_deleted"], st["graph_x"]
    live = ~np.isin(all_ids, deleted)
    kw = dict(ef=48, nprobes=8, graph_refine=0, graph_rescore=False)
    got, dist = db.search_arrays(queries[0], k=K, **kw)
    check(got.shape == (BATCH, K) and np.isfinite(dist).all(), "compact: shape/finite")
    check(not np.isin(got, deleted).any(), "compact: a deleted id was returned")
    recall = recall_vs_exact(got, torch.from_numpy(queries[0]).to(dev), x_all, live, all_ids)
    windows = sorted(sync_qps(db, queries[0], kw) for _ in range(QPS_WINDOWS))
    qps = windows[len(windows) // 2]
    launches = {"scan_topk": scan_topk.launches, "coded_group_scan": coded_group_scan.launches}
    print(f"compact search_arrays serving (ef 48, 8 probes: twice the serving profile's, no "
          f"refine, no rescore): {qps:.0f} QPS (B={BATCH}; median of {QPS_WINDOWS} windows, "
          f"range {windows[0]:.0f}-{windows[-1]:.0f}), recall@10 {recall:.5f}; launches "
          f"{launches} [{card}]", flush=True)
    check(launches["coded_group_scan"] > 0, "the compact path launched kernel B")
    case = coded_case(seg, queries[1], rng, "compact", 8, 16, 1.0, card)
    seg.release_device()
    seg.serve_compact = False
    gc.collect()
    torch.cuda.empty_cache()
    check(recall >= GRAPH_RECALL_FLOOR, f"compact serving: recall {recall} < {GRAPH_RECALL_FLOOR}")
    return launches, case


# The new phase times with fewer windows than the flat and graph phases.
TIER_WINDOWS = 3
QUANT_RECALL_FLOOR = 0.99  # SQ8 at refine_factor 10, the streamed tier
PROBED_RECALL_FLOOR = 0.90  # 16 of 128 partitions
# Reranked recall@10 floors with a pool of 100, on the corpus they were set
# for (tests/test_quantization.py: 4096 x 64-d, 32 clusters, spread 0.08).
SEGMENT_FLOORS = {"int4": 0.90, "pq": 0.90, "opq": 0.90, "bq": 0.75, "rabitq": 0.75}
# The same pool over the 1M x 128-d corpus: a query's cluster holds ~1,000
# near-equidistant rows there (sigma 0.35 in 128 dimensions), which 16-byte
# and 1-bit codes cannot rank, so a pool of 100 holds few of the true top 10.
# These are regression floors under the first measured values (PERF.md), not
# quality targets.
SEGMENT_FLOORS_1M = {"int4": 0.95, "pq": 0.25, "opq": 0.25, "bq": 0.35, "rabitq": 0.33}
# What the low floors above rest on: a pool of WIDE_POOL rows by the same
# codes (the scan_topk route; the plain score matrix for
# RaBitQ) recovers the true top 10, over the first WIDE_QUERIES queries.
WIDE_POOL, WIDE_QUERIES = 1000, 512
WIDE_POOL_FLOOR = 0.95
STREAM_BUDGET = 64 << 20  # device budget of the streamed flat cases (bytes)
# Below the graph segment's cache_bytes() (~37 MB): it streams (graph_stream).
GRAPH_STREAM_BUDGET = 16 << 20
BLOCK_ROWS = 131072  # rows a quantized or streamed scan hands the kernel at once


def median_qps(db, queries, kw, windows=TIER_WINDOWS, k=K):
    return timed_qps(lambda: db.search_arrays(queries, k=k, **kw), len(queries), windows)


def timed_qps(run, n, windows=TIER_WINDOWS) -> tuple:
    """(median, lowest, highest) QPS of `run` (n queries a call) over
    `windows` windows."""
    w = sorted(window_qps(run, n) for _ in range(windows))
    return w[len(w) // 2], w[0], w[-1]


def h2d_gbps() -> float:
    """Rate of one pinned 256 MiB host-to-device copy (GB/s)."""
    host = torch.empty(256 << 20, dtype=torch.uint8, pin_memory=True)
    devb = torch.empty(host.numel(), dtype=torch.uint8, device="cuda")
    ms = cuda_ms(lambda: devb.copy_(host, non_blocking=True), reps=5)
    return host.numel() / (ms * 1e-3) / 1e9


class PlainOnly:
    """A quantizer whose blocks always take the plain score-matrix route
    (to time that route beside the scan_topk route)."""

    def __init__(self, quant):
        self.quant = quant

    def scan_form(self, q, metric):
        return None

    def score(self, q, enc, metric):
        return self.quant.score(q, enc, metric)


def probed_plain(seg, q, state, probes, k, mask):
    """The plain version of a probed scan, as the JAX scorer masks it: the
    [B, rows] score matrix of the codes with +inf wherever the row's
    partition is none of the query's probes; top-k per 16,384-row block,
    merged."""
    from vecgo_tpu_torch.ops import topk as T

    part = torch.from_numpy(np.asarray(seg.ivf_part)).to(q.device)
    best_d = torch.full((q.shape[0], k), torch.inf, device=q.device)
    best_i = torch.full((q.shape[0], k), -1, dtype=torch.int64, device=q.device)
    for s in range(0, seg.n, 16384):
        e = min(seg.n, s + 16384)
        sc = seg.quant.score(q, {name: t[s:e] for name, t in state.items()}, seg.metric)
        ok = (part[s:e][None, :, None] == probes[:, None, :]).any(-1) & mask[s:e][None, :]
        d, i = torch.topk(torch.where(ok, sc, torch.inf), k, dim=1, largest=False)
        best_d, best_i = T.merge_topk_sorted(best_d, best_i, d, i + s, k)
    return best_d, torch.where(torch.isfinite(best_d), best_i, -1)


def quantized_engine_case(st, card):
    """5a: the SQ8 + flat IVF engine path over the flat phase's 1M rows."""
    import gc

    import vecgo_tpu_torch as vg
    from vecgo_tpu_torch.metadata import isin
    from vecgo_tpu_torch.ops import topk as T
    from vecgo_tpu_torch.ops.scan_topk import scan_topk

    dev = torch.device("cuda")
    rng, x1, u1 = st["rng"], st["x1"], st["u1"]
    q_np = st["queries"][0]
    q0 = torch.from_numpy(q_np).to(dev)
    scan_topk.launches = 0
    db = vg.Open(vg.Memory(), vg.Create(dim=DIM, flush_threshold=2**62, quantizer="sq8",
                                        flush_ivf_partitions=True), device="cuda")
    t0 = time.perf_counter()
    ids = np.asarray(db.insert_batch(x1, st["metas1"]), np.int64)
    ingest_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    db.commit()
    commit_s = time.perf_counter() - t0
    (h,) = db.engine._segments
    seg = h.segment
    parts = int(seg.meta["ivf"]["partitions"])
    check(seg.quant.kind == "sq8" and parts == N // 8192, f"sq8 segment with {parts} partitions")
    deleted = rng.choice(ids, 1000, replace=False)
    for i in deleted:
        check(db.delete(int(i)), f"delete {i}")
    print(f"quantized ingest: {N} rows in {ingest_s:.3f} s; commit (k-means over {parts} "
          f"partitions, SQ8 encode) {commit_s:.3f} s [{card}]", flush=True)

    gc.collect()
    torch.cuda.synchronize()
    check(seg._dev is None, "the device state is built at the first search")
    before = torch.cuda.memory_allocated()
    x_dev = torch.from_numpy(x1).to(dev)
    live = ~np.isin(ids, deleted)
    answers = {}
    cases = (("unfiltered", dict(refine_factor=10), None, QUANT_RECALL_FLOOR),
             ("sel10", dict(refine_factor=10, filter=isin("u", list(range(10)))), 10,
              QUANT_RECALL_FLOOR),
             ("nprobes16", dict(refine_factor=10, nprobes=16), None, PROBED_RECALL_FLOOR))
    launches = {}
    for name, kw, sel, floor in cases:
        scan_topk.launches = 0
        got, dist = db.search_arrays(q_np, k=K, **kw)
        launches[name] = scan_topk.launches
        check(got.shape == (BATCH, K) and np.isfinite(dist).all(), f"sq8 {name}: shape/finite")
        check(not np.isin(got, deleted).any(), f"sq8 {name}: a deleted id was returned")
        vis = live if sel is None else live & (u1 < sel)
        recall = recall_vs_exact(got, q0, x_dev, vis, ids)
        qps, lo, hi = median_qps(db, q_np, kw)
        answers[name] = got
        print(f"quantized search_arrays {name} (sq8 codes, pool {10 * K}, host rerank): "
              f"{qps:.0f} QPS (B={BATCH}; median of {TIER_WINDOWS} windows, range {lo:.0f}-"
              f"{hi:.0f}), recall@10 {recall:.5f} (floor {floor}), scan_topk launches a batch "
              f"{launches[name]} [{card}]", flush=True)
        check(recall >= floor, f"sq8 {name}: recall {recall} < {floor}")
        check(launches[name] > 0, f"sq8 {name}: the scan went through scan_topk")
        if st["profile"] and name != "sel10":
            profile_batch(db, q_np, kw, f"quantized sq8 {name}", card)
        if name == "unfiltered":
            # The device state: codes and norms as stored, nothing decoded.
            gc.collect()
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated() - before - x_dev.numel() * 4
            want = seg.device_bytes()
            state = sum(t.numel() * t.element_size() for t in seg._dev.values())
            print(f"quantized device state: {state} bytes in {sorted(seg._dev)} "
                  f"(device_bytes() {want}; allocated since the commit {held}; an f32 table "
                  f"would add {N * DIM * 4}) [{card}]", flush=True)
            check(state == want, f"device_bytes() {want} != the state's {state} bytes")
            check(set(seg._dev) == {"codes", "rnorm2"}, "the state holds codes and norms only")
            check(want <= held <= want + (64 << 20),
                  f"allocated {held} bytes against device_bytes() {want}")
    full, _ = db.search_arrays(q_np, k=K, refine_factor=10, nprobes=parts)
    check(np.array_equal(full, answers["unfiltered"]),
          "probing every partition returns the unprobed answer")

    # The kernel at this path's shapes, on the segment's own codes: one
    # 131,072-row block at the pool of 100 under the tombstone mask, and one
    # probed partition's row range for the queries that probe it.
    state = seg.device_state(dev)
    pool = 10 * K
    alive = torch.from_numpy(~np.isin(np.asarray(seg.ids), deleted)).to(dev)
    kernel_cases = [path_block_case(
        "sq8-block-k100", seg.quant, seg.metric, q0,
        {name: t[:BLOCK_ROWS] for name, t in state.items()}, pool,
        alive[:BLOCK_ROWS].contiguous(), card, " (the engine segment's sq8 codes, tombstones)")]
    probes = seg._probes(q0, 16)
    part = int(torch.bincount(probes.reshape(-1)).argmax())  # the most probed one
    r0, r1 = (int(v) for v in seg._part_bounds[part : part + 2])
    probing = (probes == part).any(1).nonzero().squeeze(1)
    kernel_cases.append(path_block_case(
        "sq8-probed-k100", seg.quant, seg.metric, q0[probing].contiguous(),
        {name: t[r0:r1] for name, t in state.items()}, pool, alive[r0:r1].contiguous(), card,
        f" (partition {part}, the {len(probing)} queries that probe it, tombstones)"))
    # The whole routed scans against the plain score-matrix route: the full
    # scan, and the probed scan (probe inversion, row ranges, merge) against
    # the score matrix masked per query by partition, on the first 256 queries.
    routed = seg.search(q0, pool, mask=alive)
    plain = T.blockwise_topk_scored(q0, state, N, pool,
                                    T.BlockScanner(PlainOnly(seg.quant), seg.metric), mask=alive)
    gap, tol, swaps = routes_agree("sq8 full scan", q0, state["rnorm2"], routed, plain)
    qh = q0[:256].contiguous()
    routed_p = seg.search(qh, pool, mask=alive, nprobes=16)
    plain_p = probed_plain(seg, qh, state, probes[:256], pool, alive)
    gap_p, _, swaps_p = routes_agree("sq8 probed scan", qh, state["rnorm2"], routed_p, plain_p)
    print(f"quantized routes: scan_topk route against the plain score matrix at pool {pool}: "
          f"full scan largest rank-wise gap {gap:.3g}, {swaps} of {routed[1].numel()} rows differ "
          f"(ties); nprobes 16 over 256 queries gap {gap_p:.3g}, {swaps_p} of "
          f"{routed_p[1].numel()} rows differ (tol {tol:.3g}) [{card}]", flush=True)
    del state, routed, plain, routed_p, plain_p
    t0 = time.perf_counter()
    for i in ids[live]:
        db.get(int(i))
    for i in deleted:
        try:
            db.get(int(i))
        except vg.ErrNotFound:
            continue
        raise RuntimeError(f"check failed: deleted id {i} still readable")
    print(f"quantized get: {int(live.sum())} live ids readable, 1000 deleted ids gone "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    db.close()
    seg.release_device()
    return launches, x_dev, kernel_cases


PQ_POOL_RECALL_FLOOR = 0.99  # a pool of 1,000 by PQ codes (R3 read >= 0.998, PERF.md)


def pq_engine_case(st, x_dev, card):
    """5a, last: the flat phase's rows in an engine with quantizer="pq" (m 16),
    searched at refine_factor=100: each block's pool of 1,000 goes through
    scan_topk, then the exact host rerank. QPS and recall@10
    (floor PQ_POOL_RECALL_FLOOR). Returns scan_topk's launches of one batch."""
    import vecgo_tpu_torch as vg
    from vecgo_tpu_torch.ops.scan_topk import scan_topk

    dev = torch.device("cuda")
    q_np = st["queries"][0]
    db = vg.Open(vg.Memory(), vg.Create(dim=DIM, flush_threshold=2**62, quantizer="pq",
                                        qparams={"m": 16}), device="cuda")
    t0 = time.perf_counter()
    ids = np.asarray(db.insert_batch(st["x1"], st["metas1"]), np.int64)
    db.commit()
    build_s = time.perf_counter() - t0
    kw = dict(refine_factor=100)
    scan_topk.launches = 0
    got, dist = db.search_arrays(q_np, k=K, **kw)
    launches = scan_topk.launches
    check(got.shape == (BATCH, K) and np.isfinite(dist).all(), "pq engine: shape/finite")
    check(launches > 0, "pq engine: the pool of 1,000 went through the kernel")
    recall = recall_vs_exact(got, torch.from_numpy(q_np).to(dev), x_dev, np.ones(N, bool), ids)
    qps, lo, hi = median_qps(db, q_np, kw)
    print(f"quantized search_arrays pq engine (m 16, refine_factor 100: pool {100 * K}, host "
          f"rerank): {qps:.0f} QPS (B={BATCH}; median of {TIER_WINDOWS} windows, range "
          f"{lo:.0f}-{hi:.0f}), recall@10 {recall:.5f} (floor {PQ_POOL_RECALL_FLOOR}); ingest "
          f"and commit {build_s:.3f} s; scan_topk launches a batch {launches} [{card}]", flush=True)
    check(recall >= PQ_POOL_RECALL_FLOOR, f"pq engine: recall {recall} < {PQ_POOL_RECALL_FLOOR}")
    db.close()
    return launches


def quantizer_floors_case(card):
    """The quantizers trained on the card, held to the recall floors of
    tests/test_quantization.py on that test's corpus (4096 x 64-d rows around
    32 centres, spread 0.08; 16 queries; a pool of 100, exact rerank)."""
    from vecgo_tpu_torch import quantization as Q
    from vecgo_tpu_torch.index.common import enc_tensor
    from vecgo_tpu_torch.model import Metric
    from vecgo_tpu_torch.ops.scan_topk import scan_topk_reference

    dev = torch.device("cuda")
    n, d, b = 4096, 64, 16
    r = np.random.default_rng(11)
    centers = r.random((32, d), dtype=np.float32)
    x = centers[r.integers(0, 32, size=n)] + r.standard_normal((n, d)).astype(np.float32) * 0.08
    q = x[:b] + np.random.default_rng(12).standard_normal((b, d)).astype(np.float32) * 0.02
    xd, qd = torch.from_numpy(x).to(dev), torch.from_numpy(q).to(dev)
    _, truth = scan_topk_reference(qd, xd, (xd * xd).sum(1), K, "l2", None)
    out = []
    for kind, qparams in (("sq8", {}), ("int4", {}), ("pq", {"m": 8}),
                          ("opq", {"m": 8, "opq_iters": 3}), ("bq", {}), ("rabitq", {})):
        quant = Q.create(kind, device=dev, dim=d, **qparams)
        quant.train(x)
        enc = {k: enc_tensor(v, dev) for k, v in quant.encode(x).items()}
        scores = quant.score(qd, enc, Metric.L2)
        pool = scores.argsort(1)[:, :100]
        exact = ((qd[:, None, :] - xd[pool]) ** 2).sum(-1)
        top = pool.gather(1, exact.argsort(1)[:, :K])
        recall = float(np.mean([len(set(a) & set(t)) / K for a, t in
                                zip(top.cpu().tolist(), truth.cpu().tolist())]))
        floor = SEGMENT_FLOORS.get(kind, QUANT_RECALL_FLOOR)
        out.append(f"{kind} {recall:.4f} (floor {floor})")
        check(recall >= floor, f"{kind} trained on the card: reranked recall {recall} < {floor}")
    print(f"quantizers trained on the card, 4096 x 64-d test corpus, pool 100, reranked "
          f"recall@10: {'; '.join(out)} [{card}]", flush=True)


def segment_quantizers_case(st, x_dev, card):
    """5b: the other quantizers at the segment level over the same rows."""
    import gc

    from vecgo_tpu_torch import quantization as Q
    from vecgo_tpu_torch.index.flat import FlatSegment, FlatWriter
    from vecgo_tpu_torch.model import Metric
    from vecgo_tpu_torch.ops import hamming as H
    from vecgo_tpu_torch.ops import topk as T
    from vecgo_tpu_torch.ops.scan_topk import scan_topk

    dev = torch.device("cuda")
    x1 = st["x1"]
    ids = np.arange(N, dtype=np.int64)
    q_np = st["queries"][0]
    q0 = torch.from_numpy(q_np).to(dev)
    every = np.ones(N, bool)
    xn_dev = (x_dev * x_dev).sum(1)
    launches = 0
    cases = []
    sample = x1[np.random.default_rng(42).choice(N, 65536, replace=False)]
    for kind, qparams in (("int4", {}), ("pq", {"m": 16}), ("opq", {"m": 16, "opq_iters": 3}),
                          ("bq", {}), ("rabitq", {})):
        quant = Q.create(kind, device=dev, dim=DIM, **qparams)
        t0 = time.perf_counter()
        quant.train(sample)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        enc = quant.encode(x1)
        torch.cuda.synchronize()
        encode_s = time.perf_counter() - t0
        code_bytes = sum(a.nbytes for a in enc.values()) // N
        check(code_bytes == quant.code_bytes_per_vector(),
              f"{kind}: {code_bytes} stored bytes a vector != code_bytes_per_vector()")
        del enc
        t0 = time.perf_counter()
        w = FlatWriter(DIM, Metric.L2, quantizer=kind, qparams=qparams, device=dev)
        w.add_batch(x1, ids)
        seg = FlatSegment.open(w.finish())
        write_s = time.perf_counter() - t0
        del w
        check(seg.quant.kind == kind and seg.n == N, f"{kind}: segment opened")
        scan_topk.launches = 0
        d_s, rows = seg.search(q0, 100)
        routed = scan_topk.launches > 0
        launches += scan_topk.launches
        d = seg.rerank(q0, rows)
        _, top = T.topk_smallest_with_ids(d, rows, K)
        recall = recall_vs_exact(top.cpu().numpy(), q0, x_dev, every, ids)
        scan_ms = cuda_ms(lambda: seg.search(q0, 100), reps=2)
        t0 = time.perf_counter()
        seg.rerank(q0, rows)
        torch.cuda.synchronize()
        rerank_ms = (time.perf_counter() - t0) * 1e3
        state = seg.device_state(dev)
        plain = T.BlockScanner(PlainOnly(seg.quant), Metric.L2)
        d_p, rows_p = T.blockwise_topk_scored(q0, state, N, 100, plain)
        plain_ms = cuda_ms(lambda: T.blockwise_topk_scored(q0, state, N, 100, plain), reps=1)
        least_ms = sum(a.nbytes for a in seg.enc_host.values()) / HBM_BPS * 1e3
        route = f"plain score-matrix route {scan_ms:.3f} ms (no scan_topk form)"
        if routed:
            # The kernel on a block of these codes, then the whole routed scan
            # against the plain route: the same pool up to ties, so the same
            # reranked recall.
            cases.append(path_block_case(
                f"{kind}-block-k100", seg.quant, Metric.L2, q0,
                {name: t[:BLOCK_ROWS] for name, t in state.items()}, 100, None, card,
                f" (a block of the segment's {kind} codes)"))
            gap, tol, swaps = routes_agree(f"{kind} full scan", q0, state["rnorm2"],
                                           (d_s, rows), (d_p, rows_p))
            _, top_p = T.topk_smallest_with_ids(T.rerank_exact(q0, rows_p, x_dev, xn_dev, Metric.L2),
                                                rows_p, K)
            recall_p = recall_vs_exact(top_p.cpu().numpy(), q0, x_dev, every, ids)
            check(abs(recall - recall_p) <= 0.002,
                  f"{kind}: reranked recall {recall} by the scan_topk route, {recall_p} by the plain")
            route = (f"scan_topk route {scan_ms:.3f} ms, plain score-matrix route {plain_ms:.3f} "
                     f"ms; the routes' pools agree rank by rank within {gap:.3g} (tol {tol:.3g}, "
                     f"{swaps} rows differ at ties), reranked recall@10 by the plain route "
                     f"{recall_p:.5f}")
        # The low recall of a 100-row pool on this corpus is the codes'
        # resolution, not the scan: a pool of 1,000 by the same codes holds
        # the true top 10.
        qw = q0[:WIDE_QUERIES].contiguous()
        before = scan_topk.launches
        _, rows_w = T.blockwise_topk_scored(qw, state, N, WIDE_POOL,
                                            T.BlockScanner(seg.quant, Metric.L2))
        launches += scan_topk.launches - before
        _, top_w = T.topk_smallest_with_ids(T.rerank_exact(qw, rows_w, x_dev, xn_dev, Metric.L2),
                                            rows_w, K)
        recall_w = recall_vs_exact(top_w.cpu().numpy(), qw, x_dev, every, ids)
        print(f"segment {kind} {qparams or ''}: {code_bytes} B/vector, train {train_s:.3f} s "
              f"(65,536 rows), encode {encode_s:.3f} s, write+open {write_s:.3f} s; scan "
              f"B={BATCH} pool 100: {route}; its codes once over 3.35 TB/s {least_ms:.3f} ms; "
              f"host rerank of the pool {rerank_ms:.1f} ms; reranked recall@10 {recall:.5f} "
              f"(regression floor {SEGMENT_FLOORS_1M[kind]}); with a pool of "
              f"{WIDE_POOL} over {WIDE_QUERIES} queries {recall_w:.5f} (floor "
              f"{WIDE_POOL_FLOOR}) [{card}]", flush=True)
        check(recall >= SEGMENT_FLOORS_1M[kind], f"{kind}: reranked recall {recall}")
        check(recall_w >= WIDE_POOL_FLOOR, f"{kind}: pool {WIDE_POOL} recall {recall_w}")
        if kind == "bq":
            qp = torch.from_numpy(seg.quant.encode_query(q_np[:64]).view(np.int32)).to(dev)
            blk = state["codes"][:8192]
            a = H.hamming_scores(qp, blk, DIM)
            b = H.hamming_scores_popcount(qp, blk)
            check(torch.equal(a, b), "bq: hamming_scores equals hamming_scores_popcount")
            check(torch.equal(a, seg.quant.score(qp, {"codes": blk}, Metric.HAMMING)),
                  "bq: Metric.HAMMING scores with hamming_scores")
            check(bool((a >= 0).all() and (a <= DIM).all()), "bq hamming: distances in [0, d]")
            print(f"segment bq hamming: both scorers agree on 64 x 8192 codes; nearest "
                  f"Hamming distance {float(a.min(1).values.mean()):.2f} of {DIM} bits on "
                  f"average [{card}]", flush=True)
        seg.release_device()
        del seg, state, rows, d, d_s, d_p, rows_p, rows_w
        gc.collect()
        torch.cuda.empty_cache()
    return launches, cases


def streamed_case(st, x_dev, card):
    """5c: the flat phase's segment and the graph phase's database under a
    device budget below their sizes."""
    import gc

    import vecgo_tpu_torch as vg
    from vecgo_tpu_torch.index.common import enc_tensor
    from vecgo_tpu_torch.ops import topk as T
    from vecgo_tpu_torch.ops.coded_group_scan import coded_group_scan
    from vecgo_tpu_torch.ops.scan_topk import scan_topk, scan_topk_reference

    dev = torch.device("cuda")
    q_np = st["queries"][0]
    q0 = torch.from_numpy(q_np).to(dev)
    ids1 = st["ids"][:N]
    cases = []
    every = np.ones(N, bool)
    gbps = h2d_gbps()
    print(f"pinned host-to-device copy, 256 MiB: {gbps:.2f} GB/s [{card}]", flush=True)

    resident = vg.Open(st["backend"], vg.Create(dim=0), version=st["flat_version"], device="cuda")
    want, want_d = resident.search_arrays(q_np, k=K)
    seg_bytes = resident.engine._segments[0].segment.device_bytes()
    resident.close()
    resident.engine._segments[0].segment.release_device()
    check(seg_bytes > STREAM_BUDGET, "the budget is below the segment's device_bytes()")
    launches = {}
    block_rows = BLOCK_ROWS
    # The engine's pools at k = 10 and the default refine_factor of 2: the
    # SQ8 transport keeps 2k rows, the PQ transport max(4 * 2k, 128).
    _, gt_rows = scan_topk_reference(q0, x_dev, (x_dev * x_dev).sum(1), K, "l2", None)
    gt = ids1[gt_rows.cpu().numpy()]
    for transport, pool in (("sq8", 2 * K), ("pq", 128)):
        db = vg.Open(st["backend"], vg.Create(dim=0, hbm_budget_bytes=STREAM_BUDGET,
                                              stream_transport=transport),
                     version=st["flat_version"], device="cuda")
        seg = db.engine._segments[0].segment
        t0 = time.perf_counter()
        enc_host, _ = seg.stream_state(transport, dev)
        torch.cuda.synchronize()
        state_s = time.perf_counter() - t0
        row_bytes = sum(a.nbytes for a in enc_host.values()) // N
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        scan_topk.launches = 0
        got, dist = db.search_arrays(q_np, k=K)
        torch.cuda.synchronize()
        launches[transport] = scan_topk.launches
        peak = torch.cuda.max_memory_allocated() - base
        check(got.shape == (BATCH, K) and np.isfinite(dist).all(), f"stream {transport}: shape")
        # The kernel on a block of the transport's codes at this pool, then
        # the whole streamed scan by both routes: the same pool rank by rank,
        # so whatever separates the streamed answer from the resident one is
        # the transport's codes and its pool, not the kernel's route.
        scanner = seg.stream_state(transport, dev)[1]
        cases.append(path_block_case(
            f"stream-{transport}-k{pool}", scanner.quant, scanner.metric, q0,
            {name: enc_tensor(arr[:BLOCK_ROWS], dev) for name, arr in enc_host.items()},
            pool, None, card, f" (a block of the {transport} transport's codes)"))
        routed = T.streaming_topk_scored(q0, enc_host, N, pool, scanner)
        plain = T.streaming_topk_scored(
            q0, enc_host, N, pool, T.BlockScanner(PlainOnly(scanner.quant), scanner.metric))
        gap, tol, swaps = routes_agree(f"stream {transport}", q0,
                                       torch.from_numpy(enc_host["rnorm2"].max(keepdims=True)),
                                       routed, plain)
        _, top_p = T.topk_smallest_with_ids(seg.rerank_host(q0, plain[1]), plain[1], K)
        got_p = np.asarray(seg.ids)[top_p.cpu().numpy()]
        routes_same = float((got_p == got).all(1).mean())
        plain_same = float((got_p == want).all(1).mean())
        del routed, plain
        recall = recall_vs_exact(got, q0, x_dev, every, ids1)
        # Both pools are reranked exactly, so a query's answer differs from
        # the resident run's only where one pool missed a row at its edge or
        # two rows tie.
        same = (got == want).all(1)
        edge_gap = float(np.abs(np.sort(dist[~same], 1) - np.sort(want_d[~same], 1)).max()
                         ) if (~same).any() else 0.0
        hbm = db.stats()["hbm"]
        check(hbm["resident"] == 0 and hbm["used_bytes"] == 0, f"nothing resident: {hbm}")
        # Two staging blocks, one decoded bf16 block, scan_topk's scratch and
        # lists, and the rerank's [B, pool, d] tile with its product.
        bound = (2 * block_rows * row_bytes + block_rows * DIM * 2 + 3 * BATCH * pool * DIM * 4
                 + (128 << 20))
        # Where the streamed and the resident answers differ, one of them
        # missed a row of the exact answer at its pool's edge (the resident
        # scan pools k + 8 rows by bf16 scores, the stream `pool` rows by its
        # codes): a pool four times as wide over the same codes returns the
        # exact rows there.
        differ = np.flatnonzero(~same)
        witness, pool_miss = "no query differs", True
        if len(differ):
            qd = q0[torch.from_numpy(differ).to(dev)].contiguous()
            _, rows_w = T.streaming_topk_scored(qd, enc_host, N, 4 * pool, scanner)
            _, top_w = T.topk_smallest_with_ids(seg.rerank_host(qd, rows_w), rows_w, K)
            wide = np.asarray(seg.ids)[top_w.cpu().numpy()]
            exact = np.sort(gt[differ], 1)  # as sets: near-equal rows may swap places
            stream_exact = int((np.sort(got[differ], 1) == exact).all(1).sum())
            resident_exact = int((np.sort(want[differ], 1) == exact).all(1).sum())
            wide_exact = int((np.sort(wide, 1) == exact).all(1).sum())
            witness = (f"of the {len(differ)} queries that differ the streamed answer is the "
                       f"exact one on {stream_exact}, the resident one on {resident_exact}, and "
                       f"a pool of {4 * pool} over the same codes on {wide_exact}")
            pool_miss = wide_exact == len(differ) <= stream_exact + resident_exact
        qps, lo, hi = median_qps(db, q_np, {})
        mbs = qps / BATCH * N * row_bytes / 1e9
        print(f"stream flat_stream transport {transport} ({row_bytes} B/row, pool {pool}, "
              f"transport built in {state_s:.3f} s): {qps:.0f} QPS (B={BATCH}; median of "
              f"{TIER_WINDOWS} windows, range {lo:.0f}-{hi:.0f}) = {mbs:.2f} GB/s of codes "
              f"against {gbps:.2f} GB/s pinned H2D; recall@10 {recall:.5f}; rows equal to the "
              f"resident run's {same.mean():.5f} (largest distance gap elsewhere {edge_gap:.3g})"
              f"; {witness}; by the plain score-matrix route over the same codes {plain_same:.5f}, "
              f"the two routes' answers equal on {routes_same:.5f} of the queries and their "
              f"pools rank by rank within {gap:.3g} (tol {tol:.3g}, {swaps} rows differ at "
              f"ties); "
              f"peak device memory {peak / 2**20:.1f} MiB (bound {bound / 2**20:.1f} MiB; the "
              f"resident state is {seg_bytes / 2**20:.1f} MiB); scan_topk launches a batch "
              f"{launches[transport]}; hbm {hbm} [{card}]", flush=True)
        check(recall >= QUANT_RECALL_FLOOR, f"stream {transport}: recall {recall}")
        check(peak <= bound, f"stream {transport}: peak {peak} > block-sized bound {bound}")
        check(launches[transport] > 0, f"stream {transport}: launched scan_topk")
        if st["profile"]:
            profile_batch(db, q_np, {}, f"flat_stream {transport}", card)
        # The PQ pool ranks by coarser codes, so it misses an edge row more often.
        same_floor = 0.999 if transport == "sq8" else 0.99
        check(same.mean() >= same_floor, f"stream {transport}: {same.mean():.5f} of the "
                                         f"queries return the resident run's rows")
        check(routes_same >= 0.999, f"stream {transport}: the routes agree on {routes_same}")
        check(pool_miss, f"stream {transport}: every differing query is one side's pool miss "
                         f"that a pool of {4 * pool} repairs ({witness})")
        if transport == "pq":
            # fetch_k = 100: the transport pools max(4 * 100, 128) = 400 rows.
            scan_topk.launches = 0
            got_w, _ = db.search_arrays(q_np, k=100)
            launches["pq_k100"] = scan_topk.launches
            _, gt_w = scan_topk_reference(q0, x_dev, (x_dev * x_dev).sum(1), 100, "l2", None)
            gt_w = ids1[gt_w.cpu().numpy()]
            recall_w = float(np.mean([len(set(g) & set(t)) / 100 for g, t in zip(got_w, gt_w)]))
            qps_w, lo_w, hi_w = median_qps(db, q_np, {}, k=100)
            print(f"stream flat_stream transport pq at k=100 (pool 400): {qps_w:.0f} QPS (B={BATCH}"
                  f"; median of {TIER_WINDOWS} windows, range {lo_w:.0f}-{hi_w:.0f}), recall@100 "
                  f"{recall_w:.5f}; scan_topk launches a batch {launches['pq_k100']} [{card}]",
                  flush=True)
            check(recall_w >= QUANT_RECALL_FLOOR, f"stream pq k=100: recall {recall_w}")
            check(launches["pq_k100"] > 0, "stream pq k=100: launched scan_topk")
        db.close()
        seg._streams.clear()
        del enc_host
    del x_dev
    gc.collect()
    torch.cuda.empty_cache()

    # The graph phase's database (one Vamana segment and a small flat one).
    all_ids, deleted, x_all = st["graph_ids"], st["graph_deleted"], st["graph_x"]
    live = ~np.isin(all_ids, deleted)
    scan_topk.launches = 0
    coded_group_scan.launches = 0
    db = vg.Open(st["backend"], vg.Create(dim=0, hbm_budget_bytes=GRAPH_STREAM_BUDGET),
                 device="cuda")
    kinds = {type(h.segment).__name__: h.segment.device_bytes() for h in db.engine._segments}
    graph_seg = next(h.segment for h in db.engine._segments
                     if type(h.segment).__name__ == "VamanaSegment")
    check(GRAPH_STREAM_BUDGET < graph_seg.cache_bytes(),
          f"the budget is below the cluster cache's {graph_seg.cache_bytes()} bytes")
    t0 = time.perf_counter()
    got, dist = db.search_arrays(q_np, k=K)
    first_s = time.perf_counter() - t0
    check(got.shape == (BATCH, K) and np.isfinite(dist).all(), "graph_stream: shape/finite")
    check(not np.isin(got, deleted).any(), "graph_stream: a deleted id was returned")
    recall = recall_vs_exact(got, q0, x_all, live, all_ids)
    stats = db.engine.search_batch(q_np[:1], k=K, with_stats=True)[0].stats
    qps, lo, hi = median_qps(db, q_np, {})
    hbm = db.stats()["hbm"]
    print(f"stream graph_stream (sq8 transport over the Vamana segment's rows; segments "
          f"{kinds}; first batch with the transport's build {first_s:.3f} s): {qps:.0f} QPS "
          f"(B={BATCH}; median of {TIER_WINDOWS} windows, range {lo:.0f}-{hi:.0f}), recall@10 "
          f"{recall:.5f}, plan '{stats.strategy}', hbm {hbm}, launches scan_topk "
          f"{scan_topk.launches} coded_group_scan {coded_group_scan.launches} [{card}]",
          flush=True)
    check(recall >= QUANT_RECALL_FLOOR, f"graph_stream: recall {recall}")
    check("graph=0" in stats.strategy, f"the graph segment streams: {stats.strategy}")
    check(coded_group_scan.launches == 0, "a streamed graph segment runs no resident kernel B")
    launches["graph"] = scan_topk.launches
    if st["profile"]:
        profile_batch(db, q_np, {}, "graph_stream", card)
    db.close()
    return launches, cases


def tiers_phase(st, card):
    """Phase 5: quantized flat segments, flat IVF probing and the
    beyond-device streaming tier. Returns scan_topk's launches by sub-path
    and the kernel's cases at these paths' shapes."""
    quantized, x_dev, cases = quantized_engine_case(st, card)
    quantized["pq_engine"] = pq_engine_case(st, x_dev, card)
    quantizer_floors_case(card)
    segments, segment_cases = segment_quantizers_case(st, x_dev, card)
    streamed, stream_cases = streamed_case(st, x_dev, card)
    by_path = {f"quantized_{k}": v for k, v in quantized.items()}
    by_path["segment_quantizers"] = segments
    by_path.update({f"stream_{k}": v for k, v in streamed.items()})
    print(f"tiers peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"scan_topk launches {by_path} [{card}]", flush=True)
    return by_path, cases + segment_cases + stream_cases

CACHE_BUDGET = 64 << 20  # device budget of the cached tier (bytes)
CACHED_BATCH = 64  # queries a clustered batch of the cached tier
CACHED_BATCHES = 4
CACHED_RECALL_FLOOR = 0.85  # the lower of tests/test_ivf_cache.py's floors
UNIFORM_RECALL_FLOOR = 0.99  # the uniform batch, no probe dropped (graph_stream's floor, phase 5)


def plan_kinds(engine, k=K):
    """The planner's source kinds for one search of the current snapshot."""
    from vecgo_tpu_torch.engine import search as S
    from vecgo_tpu_torch.model import SearchOptions

    snap = engine.snapshot()
    try:
        plan = S._plan_snapshot(snap, SearchOptions(k=k), engine.options, engine._device_budget)
    finally:
        snap.release()
    return [src.kind for src in plan.sources]


def cached_routes(db, seg, q_dev, card):
    """The two no-drop routes of graph_cached for batches whose probed
    clusters outnumber the cache, at the source level (what the planner's
    `_cached_source` runs for the segment): the `graph_stream` scan of the
    segment's rows (`_stream_source`) and the cache scanned chunk by chunk
    (`search_cached`), each reranked exactly from the host's rows; the
    median of 3 runs after a warm one, and recall@10 against the exact
    answer over the segment's visible rows. The whole batch q_dev and each
    of its prefixes of 16, 32, ... queries that spans more than one chunk,
    so that the lines show where the stream starts to win."""
    from vecgo_tpu_torch.engine import search as S
    from vecgo_tpu_torch.model import SearchOptions

    e = db.engine
    opts = SearchOptions(k=K)
    snap = e.snapshot()
    try:
        plan = S._plan_snapshot(snap, opts, e.options, e._device_budget)
    finally:
        snap.release()
    src = next(x for x in plan.sources if x.kind == "graph_cached")
    kk = min(K * max(opts.refine_factor, 1), src.n)
    ef = max(opts.ef or e.options.ef_search, kk)
    cc = seg.cluster_cache(device=q_dev.device)
    probes_all = seg.cached_probes(q_dev, kk, ef)
    x_seg = torch.from_numpy(np.asarray(seg.vectors)).to(q_dev.device)
    visible = np.ones(seg.n, bool) if src.mask is None else np.asarray(src.mask)
    gt_all = exact_ids(q_dev, x_seg, visible, seg.ids)
    del x_seg
    sizes = [nq for nq in (16 << i for i in range(12)) if nq < len(q_dev)] + [len(q_dev)]
    out = {}
    for nq in sizes:
        q, probes, gt = q_dev[:nq], probes_all[:nq], gt_all[:nq]
        n_chunks = len(cc.chunks(probes))
        if n_chunks < 2:
            continue

        def chunked():
            rows = seg.search_cached(q, kk, mask=src.mask, ef=ef, probes=probes)[1]
            return seg.rerank_host(q, rows), rows

        def stream():
            return S._stream_source(src, q, kk, opts, e.options)

        res = {}
        for name, fn in (("graph_stream", stream), ("cluster chunks", chunked)):
            fn()
            torch.cuda.synchronize()
            dropped = cc.stats["dropped_probes"]
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                d, rows = fn()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            top = rows.gather(1, torch.sort(d, dim=1, stable=True).indices[:, :K]).cpu().numpy()
            recall = recall_of(np.where(top >= 0, seg.ids[np.maximum(top, 0)], -1), gt)
            res[name] = (sorted(times)[1], recall, cc.stats["dropped_probes"] - dropped)
        out[nq] = (n_chunks, res)
        print(f"cached uniform batch by route (the graph_cached source alone, {nq} queries, "
              f"{len(cc._wanted(probes))} probed clusters, {n_chunks} chunks of at most "
              f"{cc.c}): " + "; ".join(
                  f"{name} {t * 1e3:.3f} ms = {nq / t:.0f} QPS, recall@10 {r:.5f}, dropped "
                  f"{dr}" for name, (t, r, dr) in res.items()) + f" [{card}]", flush=True)
        for name, (_, r, dr) in res.items():
            check(dr == 0 and r >= UNIFORM_RECALL_FLOOR, f"uniform route {name} at {nq} "
                  f"queries: recall {r}, dropped {dr}")
    return out


def timed_search(db, q_np, **kw):
    """One sync search_arrays batch: (ids, seconds)."""
    t0 = time.perf_counter()
    got, dist = db.search_arrays(q_np, k=K, **kw)
    torch.cuda.synchronize()
    check(got.shape == (len(q_np), K) and np.isfinite(dist).all(), "cached: shape/finite")
    return got, time.perf_counter() - t0


def cache_coded_inputs(cc, q, n_probe, kk):
    """Kernel B's arguments for a query batch on the cluster cache's tensors,
    as `ClusterCachedTable.probe_and_scan` builds them (its `probe_slots`:
    the probes remapped to cache slots at the batch's peak per-slot load),
    inverted as `ops/ivf.scan_groups` inverts them."""
    from vecgo_tpu_torch.ops import ivf as ivf_ops

    pm, qcap, _ = cc.probe_slots(q, n_probe)
    qtab, _ = ivf_ops._invert_probes(pm, cc.c, qcap)
    t = cc.table()
    return (q, qtab, t.codes, t.bnorm2, t.scale, t.centroids, kk), qcap


class CountingStore:
    """A blob store that counts the bytes of its ranged reads and its
    whole-object reads (the cloud tier's traffic), around the port's
    in-memory store; it offers no zero-copy view, so the engine opens its
    segments by ranged reads, as from a remote store."""

    def __init__(self):
        from vecgo_tpu_torch.blobstore import MemoryStore

        class Counting(MemoryStore):
            range_bytes = 0
            full_gets = 0
            _in_range = False

            def get_range(self, name, offset, length):
                self.range_bytes += length
                self._in_range = True
                try:
                    return super().get_range(name, offset, length)
                finally:
                    self._in_range = False

            def get(self, name):
                if not self._in_range:
                    self.full_gets += 1
                return super().get(name)

        self.store = Counting()


def cached_batch_run(db, seg, qb, q_dev, x_all, live, all_ids, label, card):
    """One clustered batch through graph_cached: its first run (the misses
    admitted) and the median of three warm reruns; the cache's counters
    over the first run; recall@10 against the exact answer."""
    cc = seg.cluster_cache(device=q_dev.device)
    before = dict(cc.stats)
    got, cold_s = timed_search(db, qb)
    delta = {key: cc.stats[key] - before[key] for key in
             ("hits", "misses", "dropped_probes", "h2d_bytes")}
    warm = sorted(timed_search(db, qb)[1] for _ in range(3))[1]
    recall = recall_vs_exact(got, q_dev, x_all, live, all_ids)
    print(f"cached {label}: first run {len(qb) / cold_s:.0f} QPS ({cold_s * 1e3:.3f} ms), warm "
          f"{len(qb) / warm:.0f} QPS ({warm * 1e3:.3f} ms); hits {delta['hits']} misses "
          f"{delta['misses']} dropped_probes {delta['dropped_probes']} h2d_bytes "
          f"{delta['h2d_bytes']}; recall@10 {recall:.5f}; cache device_bytes() "
          f"{cc.device_bytes()} [{card}]", flush=True)
    return recall, delta


def cached_recall_by_setting(db, seg, qb, q_dev, gt, label, card):
    """Where a cached batch's recall goes: recall@10 through the engine at
    its defaults (refine_factor 2, ef 64 -> 16 probes), at ef 80 (20 probes)
    and at refine_factor 10 (a pool of 100); and the share of the exact
    top-10 among the cached scan's candidates before the pool is cut, at 16
    probes with kk 8 (the JAX package's rule), 16 (the port's; 64 for PQ)
    and 64, and at 64 probes with kk 8 (witness scans: their launches do not
    count). Returns the recall by setting."""
    from vecgo_tpu_torch.ops.coded_group_scan import coded_group_scan

    cc = seg._ccache
    dropped = cc.stats["dropped_probes"]
    recall = {}
    for name, kw in (("defaults", {}), ("ef 80", dict(ef=80)),
                     ("refine_factor 10", dict(refine_factor=10))):
        recall[name] = recall_of(timed_search(db, qb, **kw)[0], gt)
    witness = coded_group_scan.launches
    found = {}
    for n_probe, kk in ((16, 8), (16, 16), (16, 64), (64, 8)):
        rows = cc.probe_and_scan(q_dev, n_probe, kk)[1].cpu().numpy()
        found[n_probe, kk] = recall_of(np.where(rows >= 0, seg.ids[np.maximum(rows, 0)], -1), gt)
    coded_group_scan.launches = witness
    print(f"cached {label} recall@10 by setting: "
          + ", ".join(f"{n} {r:.5f}" for n, r in recall.items())
          + "; exact top-10 among the scan's candidates: "
          + ", ".join(f"{p} probes kk {kk} {r:.5f}" for (p, kk), r in found.items())
          + f"; dropped_probes {cc.stats['dropped_probes'] - dropped} [{card}]", flush=True)
    return recall


def cached_phase(st, rng, card):
    """Phase 6: graph_cached over the graph phase's database under a budget
    that admits the cluster cache, then persisted codes from a counting
    store. Returns the launches of both kernels on this path and kernel B's
    cases on the cache tensors."""
    import gc

    import vecgo_tpu_torch as vg
    from vecgo_tpu_torch.ops.coded_group_scan import coded_group_scan
    from vecgo_tpu_torch.ops.ivf_cache import LazyHostTable
    from vecgo_tpu_torch.ops.scan_topk import scan_topk

    dev = torch.device("cuda")
    all_ids, deleted, x_all = st["graph_ids"], st["graph_deleted"], st["graph_x"]
    live = ~np.isin(all_ids, deleted)
    centers = st["centers"]
    scan_topk.launches = 0
    coded_group_scan.launches = 0
    db = vg.Open(st["backend"], vg.Create(dim=0, hbm_budget_bytes=CACHE_BUDGET), device="cuda")
    seg = next(h.segment for h in db.engine._segments
               if type(h.segment).__name__ == "VamanaSegment")
    kinds = plan_kinds(db.engine)
    cache_bytes, seg_bytes = seg.cache_bytes(), seg.device_bytes()
    print(f"cached plan under {CACHE_BUDGET >> 20} MiB: {kinds}; cache_bytes() {cache_bytes}, "
          f"the segment's device_bytes() {seg_bytes}; IVF membership "
          f"{tuple(seg.ivf_members.shape)} [{card}]", flush=True)
    check("graph_cached" in kinds and "graph_stream" not in kinds, f"graph_cached planned: {kinds}")
    check(cache_bytes <= CACHE_BUDGET < seg_bytes, "the budget admits the cache, not the segment")

    # The host table (the SQ8 encode of the segment's rows) and the cache's
    # tensors are built at the first batch; release_cache() drops both, as
    # the JAX cache does, so the first batch after it pays the encode.
    t0 = time.perf_counter()
    cc = seg.cluster_cache(device=dev)
    build_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    held = sum(t.numel() * t.element_size() for t in
               (cc.codes_c, cc.bn_c, cc.rows_c, cc.scale_c, cc.cent_c, cc.cent_dev, cc.cnorm2_dev))
    print(f"cached build: host table encoded from the rows and cache tensors allocated in "
          f"{build_s:.3f} s; cache tensors {held} bytes = device_bytes() {cc.device_bytes()} "
          f"(cache_bytes() {cache_bytes}; C={cc.c} S={cc.s} d={cc.d} K={cc.k}) [{card}]",
          flush=True)
    check(held == cc.device_bytes() <= cache_bytes, "the cache's device bytes")

    # Clustered traffic: batches around two centres each, or one if two
    # drop probes.
    for n_centres in (2, 1):
        batches = [clustered(rng, CACHED_BATCH,
                             centers[rng.choice(len(centers), n_centres, replace=False)])
                   for _ in range(CACHED_BATCHES)]
        seg.release_cache()
        cc = seg.cluster_cache(device=dev)
        results = []
        for i, qb in enumerate(batches):
            q_dev = torch.from_numpy(qb).to(dev)
            results.append(cached_batch_run(db, seg, qb, q_dev, x_all, live, all_ids,
                                            f"batch {i} ({n_centres} centres, {CACHED_BATCH} "
                                            f"queries)", card))
        if all(r[1]["dropped_probes"] == 0 for r in results) or n_centres == 1:
            break
    print(f"cached traffic: batches of {CACHED_BATCH} queries around {n_centres} of the "
          f"generator's centres [{card}]", flush=True)
    # Recall floors are checked at the end of the phase, after every line
    # that says where a batch's recall went has been printed.
    floors = [(recall, f"batch {i}") for i, (recall, delta) in enumerate(results)
              if delta["dropped_probes"] == 0]
    check(floors, "a batch dropped no probe")
    for i, qb in enumerate(batches):
        q_dev = torch.from_numpy(qb).to(dev)
        cached_recall_by_setting(db, seg, qb, q_dev, exact_ids(q_dev, x_all, live, all_ids),
                                 f"batch {i}", card)
    # The first batch after release_cache(): the host table's encode, then
    # every probed cluster a miss.
    seg.release_cache()
    gc.collect()
    qb = batches[0]
    got, first_s = timed_search(db, qb)
    cc = seg._ccache
    print(f"cached cold: the first batch after release_cache() (host encode, allocation, "
          f"every probe a miss) {first_s:.3f} s = {len(qb) / first_s:.1f} QPS; misses "
          f"{cc.stats['misses']} h2d_bytes {cc.stats['h2d_bytes']} [{card}]", flush=True)
    if st["profile"]:
        profile_batch(db, qb, {}, "graph_cached warm batch", card)

    # Kernel B on the cache tensors: a 4096-query batch around the last
    # batch's centres (its clusters admitted by one search first), at the
    # engine's probes for this segment (ef 80 -> 20) and kk 8 and kk 64.
    hot = clustered(rng, BATCH, centers[rng.choice(len(centers), n_centres, replace=False)])
    db.search_arrays(hot, k=K)
    q_hot = torch.from_numpy(hot).to(dev)
    # The path's launches so far; the comparisons below do not count.
    launches = {"scan_topk": scan_topk.launches, "coded_group_scan": coded_group_scan.launches}
    cases = []
    for kk in (8, 64):
        args, qcap = cache_coded_inputs(cc, q_hot, 20, kk)
        cases.append(coded_measure(f"cache-kk{kk}", args, qcap, 20, 1.0, card,
                                   note=" (the cluster cache's tensors)"))
    # The cached scan against the resident table's (`ops/ivf.ivf_scan` over
    # every cluster) on the last clustered batch, every probe cached: the
    # same rows (the resident table's centroids are the device's sums of the
    # same rows, so a probe can flip at a near tie).
    from vecgo_tpu_torch.ops import ivf as ivf_ops

    full = seg.device_state(dev)["ivfq"]
    qb_dev = torch.from_numpy(batches[-1]).to(dev)
    dropped = cc.stats["dropped_probes"]
    d_c, r_c = cc.probe_and_scan(qb_dev, 20, 8, qcap=CACHED_BATCH)
    d_f, r_f = ivf_ops.ivf_scan(qb_dev, full, n_probe=20, kk=8, qcap=CACHED_BATCH)
    r_c, r_f = r_c.cpu().numpy(), r_f.cpu().numpy()
    sets = [(set(a[a >= 0]), set(b[b >= 0])) for a, b in zip(r_c, r_f)]
    overlap = sum(len(a & b) for a, b in sets) / max(1, sum(len(b) for _, b in sets))
    equal = float(np.mean([a == b for a, b in sets]))
    print(f"cached scan against the resident table's ivf_scan (20 probes, kk 8, the last "
          f"batch): row sets equal on {equal:.5f} of the queries, overlap {overlap:.5f}; "
          f"dropped probes {cc.stats['dropped_probes'] - dropped} [{card}]", flush=True)
    check(cc.stats["dropped_probes"] == dropped and overlap >= 0.99,
          "the cached scan returns the resident table's rows")
    seg.release_device()
    del full, d_c, d_f
    scan_topk.launches = coded_group_scan.launches = 0

    # Uniform traffic: ~3,000 probed clusters, past the cache's 256 slots.
    # No probe is dropped: the engine streams such a batch (the segment's
    # rows are in host memory); the other route scans the cache chunk by
    # chunk. Both routes at the source level on the same batch and on its
    # prefixes (their launches do not count), then the engine's route end
    # to end, read from what it ran: the stream launches no kernel B and
    # never builds the cache (the batch is probed on the centroids alone).
    uni = st["queries"][1]
    q_uni = torch.from_numpy(uni).to(dev)
    cached_routes(db, seg, q_uni, card)
    seg.release_cache()
    scan_topk.launches = coded_group_scan.launches = 0
    timed_search(db, uni)  # the stream's host transport is built by now; warm
    runs = [timed_search(db, uni) for _ in range(3)]
    got, uni_s = runs[0][0], sorted(r[1] for r in runs)[1]
    recall = recall_vs_exact(got, q_uni, x_all, live, all_ids)
    cc = seg._ccache
    stats = {"batches": 0, "dropped_probes": 0, "misses": 0} if cc is None else cc.stats
    b_runs = coded_group_scan.launches
    route = "cluster chunks" if stats["batches"] else "graph_stream"
    expect = "graph_stream" if seg.rows_loaded else "cluster chunks"
    print(f"cached uniform batch ({BATCH} queries over all centres, through the engine): "
          f"{BATCH / uni_s:.0f} QPS (median of 3), route {route} (kernel B launches {b_runs}, "
          f"cache built {cc is not None}, cache batches {stats['batches']}; the planner's "
          f"route for a segment with its rows in memory: {expect}), dropped_probes "
          f"{stats['dropped_probes']}, misses {stats['misses']}, recall@10 {recall:.5f} (floor "
          f"{UNIFORM_RECALL_FLOOR}) [{card}]", flush=True)
    check(route == expect and (b_runs == 0 and cc is None) == (route == "graph_stream"),
          f"the uniform batch's route {route}, kernel B launches {b_runs}")
    check(stats["dropped_probes"] == 0, "the uniform batch dropped no probe")
    check(recall >= UNIFORM_RECALL_FLOOR, f"the uniform batch: recall {recall}")
    check(launches["coded_group_scan"] > 0, "graph_cached launched kernel B")
    db.close()
    seg.release_cache()
    del cc

    # Persisted codes: the same live rows compacted with store_codes into a
    # store that counts its reads, then reopened from it.
    x_live_dev = x_all[torch.from_numpy(live).to(dev)]
    x_live = x_live_dev.cpu().numpy()
    half = len(x_live) // 2
    first_recall = {}
    for kind in ("sq8", "pq"):
        counting = CountingStore().store
        t0 = time.perf_counter()
        w = vg.Open(vg.Remote(counting), vg.Create(dim=DIM, flush_threshold=2**62,
                                                   store_codes=kind), device="cuda")
        ids = []
        for part in (x_live[:half], x_live[half:]):  # two segments, compacted into one
            ids += w.insert_batch(part)
            w.commit()
        ids = np.asarray(ids, np.int64)
        w.compact([h.seg_id for h in w.engine._segments])
        wseg = w.engine._segments[0].segment
        check(wseg.meta["ivf"].get("codes_stored") == kind, f"store_codes={kind} persisted")
        name = w.engine._segments[0].info.name
        w.close()
        write_s = time.perf_counter() - t0
        del wseg, w
        gc.collect()
        blob_len = len(counting.get(name))
        counting.range_bytes = counting.full_gets = 0
        r = vg.Open(vg.Remote(counting, read_only=True),
                    vg.Create(dim=0, hbm_budget_bytes=CACHE_BUDGET), device="cuda")
        rseg = r.engine._segments[0].segment
        open_bytes = counting.range_bytes
        counting.full_gets = 0  # the manifest's whole reads at the open; serving makes none
        check(plan_kinds(r.engine) == ["graph_cached"], f"store_codes={kind}: graph_cached")
        check(rseg._vectors_arr is None, f"store_codes={kind}: the open deferred the vectors")
        every = np.ones(len(ids), bool)
        n_floors = len(floors)
        for i, qb in enumerate(batches[:2]):
            q_dev = torch.from_numpy(qb).to(dev)
            gt = exact_ids(q_dev, x_live_dev, every, ids)
            for run in ("first", "warm"):
                b0 = counting.range_bytes
                dropped = rseg._ccache.stats["dropped_probes"] if rseg._ccache else 0
                got, t_s = timed_search(r, qb)
                recall = recall_of(got, gt)
                dropped = rseg._ccache.stats["dropped_probes"] - dropped
                print(f"cached store_codes={kind} batch {i} {run} run: {len(qb) / t_s:.0f} QPS, "
                      f"store read {counting.range_bytes - b0} bytes against the blob's "
                      f"{blob_len}, dropped_probes {dropped}, recall@10 {recall:.5f} [{card}]",
                      flush=True)
                first_recall.setdefault((kind, i), recall)
                if dropped == 0:
                    floors.append((recall, f"store_codes={kind} batch {i} {run} run"))
            cached_recall_by_setting(r, rseg, qb, q_dev, gt, f"store_codes={kind} batch {i}", card)
        check(len(floors) > n_floors, f"store_codes={kind}: a batch dropped no probe")
        # tests/test_ivf_cache.py's criterion for the PQ transport: SQ8's
        # recall within 0.05 on the same batch (the same seeded build).
        if kind == "pq":
            for i in range(2):
                check(first_recall["pq", i] >= first_recall["sq8", i] - 0.05,
                      f"store_codes=pq batch {i}: recall {first_recall['pq', i]} against sq8's "
                      f"{first_recall['sq8', i]}")
        cc = rseg._ccache
        check(isinstance(cc.host, LazyHostTable), f"store_codes={kind}: blocks by ranged reads")
        check(rseg._vectors_arr is None and counting.full_gets == 0,
              f"store_codes={kind}: the vectors were never loaded, no whole-object read")
        served = (cc.host.store_bytes, cc.stats["h2d_bytes"])
        if kind == "sq8":
            # The persisted codes, read block by block from the store, serve
            # the rows a cache over a fresh host encode of the same rows serves
            # (these scans are a witness: their launches do not count).
            from vecgo_tpu_torch.ops.ivf_cache import ClusterCachedTable

            fresh = ClusterCachedTable(rseg.ivf_members, rseg.vectors, device=dev)
            q_dev = torch.from_numpy(batches[0]).to(dev)
            witness = coded_group_scan.launches
            r_lazy = cc.probe_and_scan(q_dev, 20, 8, qcap=CACHED_BATCH)[1]
            r_fresh = fresh.probe_and_scan(q_dev, 20, 8, qcap=CACHED_BATCH)[1]
            coded_group_scan.launches = witness
            check(torch.equal(r_lazy, r_fresh),
                  "store_codes=sq8: the persisted codes serve a fresh encode's rows")
            del fresh
        print(f"cached store_codes={kind}: written (insert, commit, compact, encode) in "
              f"{write_s:.3f} s; blob {blob_len} bytes (rows {x_live.nbytes}); open read "
              f"{open_bytes} bytes; blocks read from the store {served[0]} bytes, "
              f"uploaded {served[1]}; the vectors never loaded, no whole-object read "
              f"while serving{'; rows equal to a fresh encode of the rows' if kind == 'sq8' else ''}"
              f" [{card}]", flush=True)
        r.close()
        del rseg, r, cc, counting
        gc.collect()
    launches["scan_topk"] += scan_topk.launches
    launches["coded_group_scan"] += coded_group_scan.launches
    for recall, label in floors:
        check(recall >= CACHED_RECALL_FLOOR,
              f"cached {label}: recall@10 {recall} < {CACHED_RECALL_FLOOR}")
    return launches, cases


# Phase 7's beam build: the flat phase's rows, cut to BEAM_ROWS where the
# full build would not finish inside BEAM_BUILD_LIMIT_S on the card.
BEAM_ROWS = N
BEAM_BUILD_LIMIT_S = 300.0
FRESH_ROWS = 65_536
FRESH_FIRST = 1024  # the first insert connects everything to everything
FRESH_BATCH = 4096
FRESH_RECALL_FLOOR = 0.85  # tests/test_fresh_vamana.py's streaming floor
COMPACT_TOOL_ROWS = 40_000
INGEST_ROWS = 1 << 18


def beam_phase(st, card):
    """Phase 7: the flat phase's rows compacted with graph_build_mode="beam"
    (build_graph, build_ivf_table) and served; then FreshVamana, the
    compaction tool in a subprocess, entry(), and ingest rows/s. Returns both kernels' launches on the beam path
    and kernel B's case on the beam table."""
    import gc
    import os
    import tempfile

    import vecgo_tpu_torch as vg
    from vecgo_tpu_torch.entry import entry
    from vecgo_tpu_torch.index.fresh import FreshVamana
    from vecgo_tpu_torch.index.vamana import VamanaSegment
    from vecgo_tpu_torch.ops.coded_group_scan import coded_group_scan
    from vecgo_tpu_torch.ops.scan_topk import scan_topk

    dev = torch.device("cuda")
    rng = np.random.default_rng(17)
    x = st["x1"][:BEAM_ROWS]
    queries = st["queries"]
    scan_topk.launches = coded_group_scan.launches = 0
    torch.cuda.reset_peak_memory_stats()
    db = vg.Open(vg.Memory(), vg.Create(dim=DIM, flush_threshold=2**62,
                                        graph_build_mode="beam"), device="cuda")
    ids = np.asarray(db.insert_batch(x), np.int64)
    db.commit()
    t0 = time.perf_counter()
    db.compact([h.seg_id for h in db.engine._segments])
    build_s = time.perf_counter() - t0
    seg = db.engine._segments[0].segment
    check(type(seg) is VamanaSegment and seg.meta["alpha"] == 1.2, "a beam-built VamanaSegment")
    k_tab, s_tab = seg.ivf_members.shape
    print(f"beam compact: {len(x)} rows (cut to {BEAM_ROWS} of the flat phase's {N}: "
          f"{'none' if BEAM_ROWS == N else 'see PERF.md'}) into one VamanaSegment (r {seg.r}, "
          f"l_build {seg.meta['l_build']}, alpha 1.2) in {build_s:.3f} s; IVF table K={k_tab} x "
          f"S={s_tab} (build_ivf_table, overlap 4); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]", flush=True)
    check(len(np.unique(seg.ivf_members[seg.ivf_members >= 0])) == len(x), "every row covered")
    x_dev = torch.from_numpy(x).to(dev)
    every = np.ones(len(x), bool)
    q0 = torch.from_numpy(queries[0]).to(dev)
    gt = exact_ids(q0, x_dev, every, ids)
    # The engine's defaults (ef 64: 16 probes, one refine round, the pool
    # rescore) carry the floor; the graph phase's serving profile (4 probes,
    # no refine) is printed beside them: a probe of the overlap-4 table holds
    # a quarter of the rows a probe of the overlap-2 table holds.
    recall = {}
    for name, kw in (("defaults", {}),
                     ("serving profile", dict(ef=48, nprobes=4, graph_refine=0,
                                              graph_rescore=False))):
        got, dist = db.search_arrays(queries[0], k=K, **kw)
        check(got.shape == (BATCH, K) and np.isfinite(dist).all(), f"beam {name}: shape/finite")
        recall[name] = recall_of(got, gt)
        windows = sorted(sync_qps(db, queries[0], kw) for _ in range(TIER_WINDOWS))
        print(f"beam search_arrays {name}: {windows[len(windows) // 2]:.0f} QPS (B={BATCH}; "
              f"median of {TIER_WINDOWS} windows, range {windows[0]:.0f}-{windows[-1]:.0f}), "
              f"recall@10 {recall[name]:.5f} [{card}]", flush=True)
    launches = {"scan_topk": scan_topk.launches, "coded_group_scan": coded_group_scan.launches}
    print(f"beam path launches {launches} [{card}]", flush=True)
    check(launches["coded_group_scan"] > 0, "the beam path launched kernel B")
    case = coded_case(seg, queries[1], np.random.default_rng(7), "beam-table", 4, 16, 1.0, card)
    db.close()
    del db, seg, x_dev
    gc.collect()
    torch.cuda.empty_cache()
    check(recall["defaults"] >= GRAPH_RECALL_FLOOR, f"beam defaults: recall {recall['defaults']}")

    # FreshVamana: streaming inserts, soft deletes, consolidate, recall.
    xf = st["x1"][-FRESH_ROWS:]
    fv = FreshVamana(DIM, device="cuda")
    t0 = time.perf_counter()
    fv.insert_batch(xf[:FRESH_FIRST])
    for s0 in range(FRESH_FIRST, FRESH_ROWS, FRESH_BATCH):
        fv.insert_batch(xf[s0 : s0 + FRESH_BATCH])
    torch.cuda.synchronize()
    insert_s = time.perf_counter() - t0
    qf = torch.from_numpy(queries[2][:1024]).to(dev)
    xf_dev = torch.from_numpy(xf).to(dev)
    gt_f = exact_ids(qf, xf_dev, np.ones(FRESH_ROWS, bool), np.arange(FRESH_ROWS))
    rec_ins = recall_of(fv.search(qf, K, ef=128)[1].cpu().numpy(), gt_f)
    gone = rng.choice(FRESH_ROWS, int(0.35 * FRESH_ROWS), replace=False)
    for row in gone:
        fv.delete(int(row))
    got = fv.search(qf, K, ef=128)[1].cpu().numpy()
    check(not np.isin(got, gone).any(), "FreshVamana: a deleted row was returned")
    t0 = time.perf_counter()
    check(fv.maybe_consolidate(), "FreshVamana consolidated past its threshold")
    torch.cuda.synchronize()
    cons_s = time.perf_counter() - t0
    live = np.setdiff1d(np.arange(FRESH_ROWS), gone)
    gt_l = exact_ids(qf, xf_dev[torch.from_numpy(live).to(dev)], np.ones(len(live), bool),
                     np.arange(len(live)))
    rec_cons = recall_of(fv.search(qf, K, ef=128)[1].cpu().numpy(), gt_l)
    print(f"FreshVamana: {FRESH_ROWS} rows inserted ({FRESH_FIRST}, then batches of "
          f"{FRESH_BATCH}) in {insert_s:.3f} s = {FRESH_ROWS / insert_s:.0f} rows/s, recall@10 "
          f"{rec_ins:.5f} (ef 128); {len(gone)} soft deletes absent; consolidate {cons_s:.3f} s to "
          f"{fv.n} rows, recall@10 {rec_cons:.5f} [{card}]", flush=True)
    check(min(rec_ins, rec_cons) >= FRESH_RECALL_FLOOR, "FreshVamana recall")
    del fv, xf_dev
    gc.collect()

    # The compaction tool in a writer process over a Local directory.
    with tempfile.TemporaryDirectory() as d:
        xc = st["x1"][:COMPACT_TOOL_ROWS]
        w = vg.Open(vg.Local(d), vg.Create(dim=DIM, flush_threshold=2**62), device="cuda")
        cids = w.insert_batch(xc[: COMPACT_TOOL_ROWS // 2])
        w.commit()
        cids += w.insert_batch(xc[COMPACT_TOOL_ROWS // 2 :])
        w.commit()
        w.close()
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "vecgo_tpu_torch.tools.compact", d, "--all"],
                           capture_output=True, text=True, timeout=300,
                           cwd=os.path.dirname(os.path.dirname(os.path.abspath(vg.__file__))))
        tool_s = time.perf_counter() - t0
        check(r.returncode == 0, f"tools.compact exit {r.returncode}: {r.stderr[-2000:]}")
        out = json.loads(r.stdout.strip().splitlines()[-1])
        rd = vg.Open(vg.Local(d), device="cuda")
        kinds = [type(h.segment).__name__ for h in rd.engine._segments]
        hit = rd.search(xc[55], k=1)[0].id
        rd.close()
        print(f"tools.compact subprocess: {out} in {tool_s:.3f} s (process included); the "
              f"reopened directory holds {kinds}, search finds row 55 [{card}]", flush=True)
        check(out["rows"] == COMPACT_TOOL_ROWS and kinds == ["VamanaSegment"] and hit == cids[55],
              "tools.compact compacted the directory")

    # entry() on the card.
    t0 = time.perf_counter()
    fn, args = entry()
    res_d, res_i = fn(*args)
    torch.cuda.synchronize()
    entry_s = time.perf_counter() - t0
    ms = cuda_ms(lambda: fn(*args), reps=5)
    check(res_i.shape == (64, 10) and res_i.is_cuda and bool(torch.isfinite(res_d).all()),
          "entry() on the card")
    print(f"entry(): build + first step {entry_s:.3f} s, step {ms:.3f} ms, out "
          f"{tuple(res_i.shape)} on {res_i.device} [{card}]", flush=True)

    # Ingest: insert_batch's copy and finiteness check.
    xi = st["x1"][:INGEST_ROWS]
    rates = []
    for _ in range(2):
        db = vg.Open(vg.Memory(), vg.Create(dim=DIM, flush_threshold=2**62), device="cuda")
        t0 = time.perf_counter()
        db.insert_batch(xi)
        rates.append(INGEST_ROWS / (time.perf_counter() - t0))
        db.close()
    print(f"ingest (insert_batch of {INGEST_ROWS} x {DIM} rows, no metadata): "
          f"{', '.join(f'{r:.0f}' for r in rates)} rows/s [{card}]", flush=True)
    return launches, case


HYBRID_DOCS = N  # bench.py's phase_hybrid text model at the smoke's scale
HYBRID_INGEST_LIMIT_S = 300.0  # past it, cut HYBRID_DOCS to 524,288 (PERF.md §4)
HYBRID_VOCAB = 20_000
HYBRID_WORDS = 12  # words a doc (bench.py:837-843)
HYBRID_INGEST_BATCH = 65_536
HYBRID_CHECK = 256  # queries held to the exact host index
HYBRID_SINGLE = 32  # queries held to the per-query hybrid_search
HYBRID_WRITES = 1000
HYBRID_POOL = max(2 * K, 20)  # hybrid_search_batch's rank window at k = K
# tests/test_lexical_device.py's criteria: shared scores within 2e-2, and
# ids overlap >= 0.7 of the exact top 10.
LEX_SCORE_TOL = 2e-2
LEX_OVERLAP_FLOOR = 0.7
# A weight rounded to bf16 moves by at most 2^-9 of itself, so a doc's
# score by at most 2^-9 of the score, and two docs swap places only where
# their exact scores are within 2^-8 of the larger: a bf16 near-tie.
BF16_NEAR_TIE = 2.0 ** -8


def zipf_texts(rng, n, words):
    """bench.py's text model: `words` zipf(1.3) words from a 20,000-word
    vocabulary, clipped at 19,999."""
    ids = np.minimum(rng.zipf(1.3, (n, words)) - 1, HYBRID_VOCAB - 1)
    return [" ".join(f"w{w}" for w in row) for row in ids.tolist()]


def exact_bm25(snap, text, slots, cache):
    """The f64 sum of each slot's BM25 weights for the query's terms (the
    snapshot's f32 weight formula, BM25Index's), slot by slot."""
    from vecgo_tpu_torch.lexical.bm25 import tokenize

    out = np.zeros(len(slots))
    for t in sorted(set(tokenize(text))):
        if t not in snap.index._postings:
            continue
        if t not in cache:
            cache[t] = snap._weights_for(t)
        s, w = cache[t]
        pos = np.minimum(np.searchsorted(s, slots), max(len(s) - 1, 0))
        hit = (s[pos] == slots) if len(s) else np.zeros(len(slots), bool)
        out[hit] += w[pos[hit]]
    return out


def lexical_check(idx, snap, texts, card):
    """The snapshot against the exact host index (BM25Index.search_batch)
    on these queries, by tests/test_lexical_device.py's criteria: the same
    number of hits, shared scores within LEX_SCORE_TOL, and wherever the
    ids differ, the device's hits score (exactly) what the host's score
    rank by rank within a bf16 near-tie. Prints the top-1 and top-10
    agreement; returns the mean overlap."""
    want = idx.search_batch(texts, K)
    got_ids, got_sc = snap.search_batch_arrays(texts, K)
    top1 = swaps = 0
    overlaps, cache = [], {}
    for r, hits in enumerate(want):
        w_ids = np.asarray([i for i, _ in hits], np.int64)
        w_sc = np.asarray([s for _, s in hits])
        g_ids = got_ids[r][got_ids[r] >= 0]
        check(len(g_ids) == len(w_ids), f"lexical query {r}: {len(g_ids)} hits, host {len(w_ids)}")
        if not len(w_ids):
            continue
        wmap = dict(hits)
        for i, s in zip(g_ids, got_sc[r]):
            if int(i) in wmap:
                check(abs(s - wmap[int(i)]) < LEX_SCORE_TOL * max(1.0, abs(wmap[int(i)])),
                      f"lexical query {r}: id {i} scores {s}, host {wmap[int(i)]}")
        overlaps.append(len(set(g_ids.tolist()) & set(w_ids.tolist())) / len(w_ids))
        top1 += int(g_ids[0] == w_ids[0])
        if not np.array_equal(g_ids, w_ids):
            swaps += 1
            slots = np.asarray([idx._doc_slot[int(i)] for i in g_ids], np.int64)
            e = np.sort(exact_bm25(snap, texts[r], slots, cache))[::-1]
            gap = float(np.abs(e - w_sc).max())
            check(gap <= BF16_NEAR_TIE * w_sc[0],
                  f"lexical query {r}: exact scores of the device's hits differ from the "
                  f"host's by {gap} > a bf16 near-tie ({BF16_NEAR_TIE * w_sc[0]})")
    n = len(overlaps)
    print(f"lexical vs exact host index on {len(texts)} queries ({n} with hits): top-1 equal on "
          f"{top1}/{n}, ids overlap mean {np.mean(overlaps):.5f} (min {min(overlaps):.2f}, "
          f"below {LEX_OVERLAP_FLOOR} on {sum(o < LEX_OVERLAP_FLOOR for o in overlaps)}); "
          f"{swaps} queries whose ids differ, each within a bf16 near-tie of the host's exact "
          f"scores rank by rank [{card}]", flush=True)
    return float(np.mean(overlaps))


def sweep_agree(name, q, w, alive, got, want):
    """Hold one BM25 sweep's answer to another's: the same +inf slots,
    scores within REL_TOL of the score itself (f32 sums of the same exact
    products in another order), ids equal except where the two rows'
    exact (f64) scores tie within that, no dead slot. q is the multi-hot
    query. Returns (max abs error, max relative error, tie swaps)."""
    (d_k, i_k), (d_r, i_r) = got, want
    check(torch.equal(torch.isfinite(d_k), torch.isfinite(d_r)), f"{name}: +inf slots differ")
    fin = torch.isfinite(d_r)
    tol = REL_TOL * d_r.abs()
    err = float((d_k - d_r).abs()[fin].max())
    rel = float(((d_k - d_r).abs() / d_r.abs().clamp_min(1e-30))[fin].max())
    check(bool(((d_k - d_r).abs() <= tol)[fin].all()), f"{name}: relative error {rel}")
    bad = (i_k != i_r) & fin
    if bad.any():
        bq, bj = bad.nonzero(as_tuple=True)
        exact = -(q[bq].double() * w[i_k[bq, bj].long()].double()).sum(1)
        gap = (exact - d_r[bq, bj].double()).abs()
        check(bool((gap <= 2 * tol[bq, bj]).all()),
              f"{name}: {int(bad.sum())} ids differ beyond exact ties")
    check(bool(alive[i_k[fin].long()].all()), f"{name}: a dead slot was returned")
    return err, rel, int(bad.sum())


def hybrid_kernel_case(snap, texts, k, card):
    """The device BM25 sweep at its shape: the snapshot's bf16 table (N =
    n_slots, H padded to 64), these texts' hot columns, the alive mask.
    `scan_topk_columns` (the "columns" product must run) is held to its
    plain version and to the dense function (scan_topk's plain version on
    the multi-hot query), and timed beside its bound (the table's bytes
    read once, against the query columns' f32 additions at the FMA peak),
    its plain version and the JAX route in torch ops (`route_ms`, on the
    multi-hot query). The dense deep product at the same shape, held to its
    plain version, is timed beside it as "hybrid-bm25-dense". Returns both
    cases."""
    from vecgo_tpu_torch.model import Metric
    from vecgo_tpu_torch.ops.scan_topk import (scan_topk, scan_topk_columns,
                                               scan_topk_columns_reference, scan_topk_reference)

    w, alive = snap._device()
    cols, q = snap.multi_hot(snap.encode_queries(texts)[0])
    got = scan_topk_columns(cols, w, k, alive)
    ran = scan_topk.last_product
    check(ran == "columns", f"bm25 sweep: the {ran} product ran, not columns")
    plain = scan_topk_columns_reference(cols, w, k, alive)
    dense_args = (q, w, None, k, Metric.DOT, alive)
    dense_plain = scan_topk_reference(*dense_args)
    torch.cuda.synchronize()
    err, rel, swaps = sweep_agree("bm25 sweep vs its plain version", q, w, alive, got, plain)
    err_d, rel_d, swaps_d = sweep_agree("bm25 sweep vs the dense function", q, w, alive, got,
                                        dense_plain)
    ms = cuda_ms(lambda: scan_topk_columns(cols, w, k, alive), reps=5)
    plain_ms = cuda_ms(lambda: scan_topk_columns_reference(cols, w, k, alive), reps=1)
    route = route_ms(*dense_args)
    (b, h), n = q.shape, w.shape[0]
    nnz = int((cols >= 0).sum())
    nbytes = n * h * 2 + n + cols.numel() * cols.element_size() + b * k * 8
    bound_ms, bound_by = bound(float(nnz) * n, nbytes, False)
    print(f"kernel hybrid-bm25: B={b} N={n} H={len(snap.hot)} (width {h}) k={k} bf16 dot mask "
          f"{1 - float(alive.float().mean()):.3%} out, {nnz} query columns: {ran} product "
          f"{ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}: the table read once), share "
          f"{bound_ms / ms:.1%}; plain {plain_ms:.3f} ms, route (torch.mm + torch.topk on the "
          f"multi-hot query) {route:.3f} ms; max_abs_err {err:.3g}, max relative {rel:.3g} "
          f"against the plain version, {err_d:.3g} / {rel_d:.3g} against the dense function "
          f"(tol {REL_TOL:g}), tie swaps {swaps} / {swaps_d} [{card}]", flush=True)
    columns = {"name": "hybrid-bm25", "product": ran, "err": max(err, err_d), "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
               "share": bound_ms / ms, "route_ms": route}

    d_k, i_k = scan_topk(*dense_args)
    ran = scan_topk.last_product
    check(ran == "deep", f"bm25 dense sweep: the {ran} product ran, not deep")
    torch.cuda.synchronize()
    err, rel, swaps = sweep_agree("bm25 dense sweep", q, w, alive, (d_k, i_k), dense_plain)
    ms = cuda_ms(lambda: scan_topk(*dense_args), reps=3)
    plain_ms = cuda_ms(lambda: scan_topk_reference(*dense_args), reps=1)
    mm = mm_ms(q, w)
    nbytes = b * h * 4 + n * h * 2 + n + b * k * 8
    dense_ms, dense_by = bound(2.0 * b * n * h, nbytes, True)
    print(f"kernel hybrid-bm25-dense: the same sweep through scan_topk on the multi-hot [B, "
          f"{h}] query: {ran} product {ms:.3f} ms, dense bound {dense_ms:.3f} ms ({dense_by}), "
          f"share {dense_ms / ms:.1%}; plain {plain_ms:.3f} ms, torch.mm product alone "
          f"{mm:.3f} ms, max_abs_err {err:.3g}, max relative {rel:.3g} (tol {REL_TOL:g}), tie "
          f"swaps {swaps} [{card}]", flush=True)
    dense = {"name": "hybrid-bm25-dense", "product": ran, "err": err, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": dense_ms, "bound_by": dense_by,
             "share": dense_ms / ms, "route_ms": route, "mm_ms": mm}
    return [columns, dense]


def hybrid_phase(st, card):
    """Phase 8: BM25 and hybrid search over the flat phase's rows with
    bench.py's text model. Returns scan_topk's launches on the hybrid path
    and the kernel cases at the sweep's shape (the columns product and the
    dense deep product)."""
    import gc

    import vecgo_tpu_torch as vg
    from vecgo_tpu_torch.ops.scan_topk import scan_topk

    rng = np.random.default_rng(99)
    x = st["x1"][:HYBRID_DOCS]
    n = len(x)
    t0 = time.perf_counter()
    texts = zipf_texts(rng, n, HYBRID_WORDS)
    texts_s = time.perf_counter() - t0
    scan_topk.launches = 0
    db = vg.Open(vg.Memory(), vg.Create(dim=DIM, lexical=True, flush_threshold=2**62),
                 device="cuda")
    t0 = time.perf_counter()
    ids = []
    for s0 in range(0, n, HYBRID_INGEST_BATCH):
        ids += db.insert_batch(x[s0 : s0 + HYBRID_INGEST_BATCH],
                               texts=texts[s0 : s0 + HYBRID_INGEST_BATCH])
    ingest_s = time.perf_counter() - t0
    ids = np.asarray(ids, np.int64)
    t0 = time.perf_counter()
    db.commit()
    commit_s = time.perf_counter() - t0
    eng = db.engine
    idx = eng._lexical
    print(f"hybrid ingest: {n} docs ({HYBRID_WORDS} zipf(1.3) words over {HYBRID_VOCAB}, texts made "
          f"in {texts_s:.3f} s) through insert_batch(texts=) in batches of {HYBRID_INGEST_BATCH}: "
          f"{ingest_s:.3f} s = {n / ingest_s:.0f} rows/s (the per-row path: BM25Index.add); "
          f"commit {commit_s:.3f} s [{card}]", flush=True)
    check(ingest_s <= HYBRID_INGEST_LIMIT_S,
          f"hybrid ingest {ingest_s:.0f} s > {HYBRID_INGEST_LIMIT_S:.0f} s: cut HYBRID_DOCS")

    q_vec = st["queries"][0]
    q_txt = zipf_texts(rng, BATCH, 3)
    # The exact host path first (lexical_device="off" and no snapshot yet, as
    # bench.py's phase_hybrid runs it; a fresh snapshot would serve even
    # under "off", as in the JAX engine), held to hybrid_search query by
    # query (tests/test_engine.py's criterion).
    eng.options.lexical_device = "off"
    t0 = time.perf_counter()
    off, off_sc = db.hybrid_search_batch(q_vec[:HYBRID_CHECK], q_txt[:HYBRID_CHECK], k=K)
    off_s = time.perf_counter() - t0
    check(eng._lexical_dev is None, "the off leg built no snapshot")
    t0 = time.perf_counter()
    for i in range(HYBRID_SINGLE):
        single = db.hybrid_search(q_vec[i], q_txt[i], k=K)
        want = [c.id for c in single]
        check([int(v) for v in off[i] if v >= 0] == want,
              f"hybrid query {i}: batch {off[i]} != single {want}")
        for j, c in enumerate(single):
            check(abs(-c.distance - float(off_sc[i, j])) < 1e-6, f"hybrid query {i}: RRF mass")
    single_s = time.perf_counter() - t0
    print(f"hybrid exact host path (lexical_device=\"off\"): {HYBRID_CHECK / off_s:.1f} QPS "
          f"({HYBRID_CHECK} queries in {off_s:.3f} s); equals hybrid_search on {HYBRID_SINGLE} "
          f"queries ({single_s / HYBRID_SINGLE * 1e3:.1f} ms a query), RRF mass within 1e-6 "
          f"[{card}]", flush=True)
    eng.options.lexical_device = "auto"

    torch.cuda.synchronize()
    alloc0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    snap = eng.enable_device_lexical()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    alloc = torch.cuda.memory_allocated() - alloc0
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"device BM25 snapshot (max_hot_terms 4096, min_df 8): built in {build_s:.3f} s, "
          f"H={len(snap.hot)} (width {snap.width}), n_slots {snap.n_slots}, device_bytes() "
          f"{snap.device_bytes()} ({snap.device_bytes() / total:.1%} of the card's "
          f"{total / 2**30:.1f} GiB), allocated {alloc} [{card}]", flush=True)
    check(len(snap.hot) == 4096 and snap.width == 4096, "the hot vocabulary fills its cap")
    check(0 <= alloc - snap.device_bytes() <= snap.n_slots + (2 << 20),
          "the snapshot allocates its table and its alive mask, nothing else")

    _, rare = snap.encode_queries(q_txt)
    rare_share = sum(1 for r_ in rare if r_) / BATCH
    qps, lo, hi = timed_qps(lambda: snap.search_batch_arrays(q_txt, K), BATCH)
    check(scan_topk.last_product == "columns", "the lexical sweep ran on the columns product")
    print(f"lexical-only search_batch_arrays(k={K}): {qps:.0f} QPS (B={BATCH}; median of "
          f"{TIER_WINDOWS} windows, range {lo:.0f}-{hi:.0f}); {rare_share:.2%} of the queries take "
          f"the rare merge [{card}]", flush=True)
    overlap = lexical_check(idx, snap, q_txt[:HYBRID_CHECK], card)
    check(overlap >= LEX_OVERLAP_FLOOR, f"lexical overlap {overlap}")

    # Hybrid through the snapshot: pool 20, so the sweep runs at kk 36; the
    # lexical half's launches are the batch's less a vector search's alone.
    before = scan_topk.launches
    got, sc = db.hybrid_search_batch(q_vec, q_txt, k=K)
    mid = scan_topk.launches
    db.search_arrays(q_vec, k=HYBRID_POOL)
    lexical_launches = (mid - before) - (scan_topk.launches - mid)
    check(got.shape == (BATCH, K) and np.isfinite(sc).all(), "hybrid: shape/finite")
    check(lexical_launches > 0, "the lexical half launched scan_topk")
    db.hybrid_search_batch(q_vec, q_txt, k=K)
    check(scan_topk.last_product == "columns", "the hybrid batch swept on the columns product")
    h_qps, h_lo, h_hi = timed_qps(lambda: db.hybrid_search_batch(q_vec, q_txt, k=K), BATCH)
    agree = np.mean([len(set(a[a >= 0]) & set(b[b >= 0])) / max(1, (b >= 0).sum())
                     for a, b in zip(got[:HYBRID_CHECK], off)])
    same_rows = int((got[:HYBRID_CHECK] == off).all(1).sum())
    print(f"hybrid_search_batch(k={K}, pool {HYBRID_POOL}) through the snapshot: {h_qps:.0f} QPS "
          f"(B={BATCH}; median of {TIER_WINDOWS} windows, range {h_lo:.0f}-{h_hi:.0f}); "
          f"scan_topk launches a batch: {mid - before} ({lexical_launches} by the lexical half); "
          f"agrees with the exact host path on {agree:.5f} of the ids ({same_rows}/"
          f"{HYBRID_CHECK} rows identical) [{card}]", flush=True)
    if st["profile"]:
        profile_batch(db, None, None, "hybrid batch", card,
                      run=lambda: db.hybrid_search_batch(q_vec, q_txt, k=K))

    # Writes: 1,000 deletes and 1,000 inserts (one with a unique term); the
    # next batch rebuilds the snapshot by itself.
    gone = rng.choice(ids, HYBRID_WRITES, replace=False)
    for i in gone:
        check(db.delete(int(i)), f"delete {i}")
    new_x = clustered(rng, HYBRID_WRITES, st["centers"])
    new_t = zipf_texts(rng, HYBRID_WRITES, HYBRID_WORDS)
    new_t[7] = "uniqueterm " + new_t[7]
    new_ids = np.asarray(db.insert_batch(new_x, texts=new_t), np.int64)
    del snap
    t0 = time.perf_counter()
    got2, _ = db.hybrid_search_batch(q_vec, q_txt, k=K)
    rebuild_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    db.hybrid_search_batch(q_vec, q_txt, k=K)
    steady_s = time.perf_counter() - t0
    key, snap2 = eng._lexical_dev
    check(key == (eng._version, eng._lsn) and snap2.n_docs == n,
          "the snapshot was rebuilt for the writes")
    lex2, _ = snap2.search_batch_arrays(q_txt, K)
    check(not np.isin(got2, gone).any() and not np.isin(lex2, gone).any(),
          "a deleted id was returned")
    found = snap2.search_batch(["uniqueterm"], K)[0]
    hyb, _ = db.hybrid_search_batch(new_x[7:8], ["uniqueterm"], k=K)
    check(found[0][0] == new_ids[7] and hyb[0, 0] == new_ids[7], "the new doc is found by its term")
    print(f"writes: {HYBRID_WRITES} deletes and {HYBRID_WRITES} inserts; the next hybrid batch "
          f"rebuilt the snapshot by itself: {rebuild_s:.3f} s with the rebuild, {steady_s:.3f} s "
          f"after it; no deleted id returned, the new doc found by its term [{card}]", flush=True)
    launches = scan_topk.launches
    cases = hybrid_kernel_case(snap2, q_txt, min(HYBRID_POOL + snap2.pool_margin, snap2.n_slots),
                               card)
    db.close()
    del db, eng, snap2, idx
    gc.collect()
    torch.cuda.empty_cache()
    return launches, cases


# Phase 9: the device grid. Four shards laid over the cards present,
# round-robin (cuda:0 four times on one card), at (dp 1, shard 4) and, for
# the engine plane, also at (dp 2, shard 2).
GRID_SHARDS = 4
GRID_SHAPES = ((1, 4), (2, 2))
# Sharded and one-device exact scans: the same kernel over the same rows, so
# ids agree except at ties and distances within this, relative to the
# largest.
GRID_REL_TOL = 1e-4
KMEANS_K = 1024
# The sharded k-means step against a one-entry grid's: the same
# [65,536-row, K] distance blocks and assignments; the sums differ only in
# their order (atomic index_add_), a few fp32 ulp of each centre.
KMEANS_REL_TOL = 1e-4
GRID_BUILD_QUERIES = 256
EXAMPLES = ("basic", "bulk_load", "cloud_tiered", "explain", "filtered_search", "hybrid_rag",
            "multi_writer_commit_plane", "observability", "quantized_index", "time_travel")


def grid(dp, shard):
    """A (dp, shard) grid over the cards present, round-robin."""
    from vecgo_tpu_torch.parallel.mesh import make_mesh

    cards = torch.cuda.device_count()
    return make_mesh(shard=shard, dp=dp, devices=[f"cuda:{i % cards}" for i in range(dp * shard)])


def grid_line(mesh) -> str:
    return (f"grid {mesh.shape} over {[str(d) for d in mesh.entries()]} "
            f"(torch.cuda.device_count() {torch.cuda.device_count()})")


def launch_counts():
    from vecgo_tpu_torch.ops.coded_group_scan import coded_group_scan
    from vecgo_tpu_torch.ops.scan_topk import scan_topk

    return {"scan_topk": scan_topk.launches, "coded_group_scan": coded_group_scan.launches}


def zero_launches():
    from vecgo_tpu_torch.ops.coded_group_scan import coded_group_scan
    from vecgo_tpu_torch.ops.scan_topk import scan_topk

    scan_topk.launches = coded_group_scan.launches = 0


def add_launches(total, part):
    for name, n in part.items():
        total[name] = total.get(name, 0) + n


def same_up_to_ties(name, got_i, got_d, want_i, want_d, rel=GRID_REL_TOL):
    """Ids equal wherever the distances do not tie within rel of the
    largest; distances within that everywhere."""
    got_d, want_d = got_d.double(), want_d.double()
    check(torch.equal(torch.isfinite(got_d), torch.isfinite(want_d)), f"{name}: +inf slots")
    fin = torch.isfinite(want_d)
    tol = rel * max(1.0, float(want_d[fin].abs().max()))
    check(float((got_d - want_d).abs()[fin].max()) <= tol, f"{name}: distances within {rel}")
    diff = (got_i != want_i).any(1).nonzero()[:, 0].tolist()
    for b in diff:
        g, w, gd = got_i[b].tolist(), want_i[b].tolist(), got_d[b]
        for j in range(len(g)):
            if g[j] != w[j]:
                ties = (gd - gd[j]).abs() <= tol
                check({g[t] for t in range(len(g)) if ties[t]}
                      == {w[t] for t in range(len(w)) if ties[t]}, f"{name}: ids beyond ties")
    return len(diff)


def sharded_flat_phase(st, card):
    """Phase 9a-b, on the flat phase's database: ShardedFlat over its
    1,048,576 committed rows at L2 and cosine against the one-device
    scan_topk answer; then db.sharded_searcher(grid) after its deletes."""
    from vecgo_tpu_torch.model import Metric
    from vecgo_tpu_torch.ops.topk import blockwise_topk_search
    from vecgo_tpu_torch.parallel.mesh import ShardedFlat, _norms_sq

    mesh = grid(1, GRID_SHARDS)
    print(f"phase 9: {grid_line(mesh)} [{card}]", flush=True)
    x = st["x_all"][:N]
    q = torch.from_numpy(st["queries"][1]).to(x.device)
    launches = {}
    for metric in (Metric.L2, Metric.COSINE):
        xs = x / torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp_min(1e-30) \
            if metric == Metric.COSINE else x
        xn = _norms_sq(xs)
        zero_launches()
        t0 = time.perf_counter()
        sf = ShardedFlat(x, mesh, metric=metric)
        d_g, i_g = sf.search(q, K)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        add_launches(launches, launch_counts())
        check(launches["scan_topk"] > 0, "ShardedFlat launched scan_topk")
        d_1, i_1 = blockwise_topk_search(q, xs, K, metric=metric, x_norms_sq=xn,
                                         x_normalized=True)
        ties = same_up_to_ties(f"sharded flat {metric.value}", i_g, d_g, i_1, d_1)
        qps, lo, hi = timed_qps(lambda: sf.search(q, K)[1].cpu(), BATCH)
        if st["profile"] and metric == Metric.L2:
            profile_batch(None, None, None, "sharded flat l2", card,
                          run=lambda: sf.search(q, K)[1].cpu())
        qps1, lo1, hi1 = timed_qps(
            lambda: blockwise_topk_search(q, xs, K, metric=metric, x_norms_sq=xn,
                                          x_normalized=True)[1].cpu(), BATCH)
        print(f"sharded flat {metric.value} over {N} x {DIM} rows, grid {mesh.shape}: ids equal "
              f"to the one-device scan_topk answer ({ties} of {BATCH} queries differ, each at a "
              f"tie), distances within {GRID_REL_TOL}; {qps:.0f} QPS (range {lo:.0f}-{hi:.0f}) "
              f"against the one-device scan's {qps1:.0f} (range {lo1:.0f}-{hi1:.0f}); built and "
              f"first batch {first_s:.3f} s [{card}]", flush=True)
        del sf, xs, xn
    # 9b: the flat phase's database after its deletes, committed rows only.
    db, ids, deleted = st["db"], st["ids"], st["deleted"]
    live = ~np.isin(ids[:N], deleted)
    zero_launches()
    t0 = time.perf_counter()
    searcher = db.sharded_searcher(mesh)
    build_s = time.perf_counter() - t0
    got, dist = searcher.search(st["queries"][1], K)
    add_launches(launches, launch_counts())
    xn_host = torch.from_numpy(np.einsum("nd,nd->n", st["x1"], st["x1"], dtype=np.float64)
                               .astype(np.float32)).to(x.device)
    d_1, rows = blockwise_topk_search(q, x, K, metric=Metric.L2, x_norms_sq=xn_host,
                                      mask=torch.from_numpy(live).to(x.device))
    exact = ids[:N][rows.cpu().numpy()]
    ties = same_up_to_ties("sharded searcher", torch.from_numpy(got), torch.from_numpy(dist),
                           torch.from_numpy(exact), d_1.cpu())
    recall = recall_of(got, exact)
    plain = recall_vs_exact(got, q, x, live, ids[:N])
    qps, lo, hi = timed_qps(lambda: searcher.search(st["queries"][1], K), BATCH)
    print(f"db.sharded_searcher over the flat phase's {N} committed rows ({int((~live).sum())} "
          f"of them deleted), grid {mesh.shape}: recall@10 {recall:.5f} against the exact "
          f"one-device answer over the visible committed rows ({ties} queries differ, each at "
          f"a tie), {plain:.5f} against the plain "
          f"PyTorch answer; built in {build_s:.3f} s; {qps:.0f} QPS (range {lo:.0f}-{hi:.0f}) "
          f"[{card}]", flush=True)
    check(plain >= RECALL_FLOOR, f"sharded searcher: recall {plain} against the plain answer")
    check(not np.isin(got, deleted).any(), "sharded searcher: a deleted id was returned")
    del searcher
    torch.cuda.empty_cache()
    return launches


def sharded_engine_phase(st, seg, card):
    """Phase 9c: ShardedEngineSearcher over the graph phase's database (the
    coded Vamana segment, the memtable's 10k rows, deletes) after a few
    updates, at both grid shapes and refine_steps 0 and 2."""
    from vecgo_tpu_torch.parallel.engine_shard import ShardedEngineSearcher

    db, rng = st["db"], np.random.default_rng(19)
    all_ids, deleted, x_all = st["graph_ids"], st["graph_deleted"], st["graph_x"]
    dev = x_all.device
    q_np = st["queries"][0]
    q0 = torch.from_numpy(q_np).to(dev)
    live = ~np.isin(all_ids, deleted)
    # Updates: ids that are some queries' exact nearest row get a new
    # vector around a random centre, so their stale rows would surface.
    top1 = exact_ids(q0, x_all, live, all_ids)[:, 0]
    upd = np.unique(top1)[:8]
    new = clustered(rng, len(upd), st["centers"])
    pos = np.searchsorted(all_ids, upd)
    check(bool((all_ids[pos] == upd).all()), "updated ids are known")
    for i, v in zip(upd, new):
        db.insert(v, {"u": int(st["graph_u"][np.searchsorted(all_ids, i)])}, id=int(i))
    x_all[torch.from_numpy(pos).to(dev)] = torch.from_numpy(new).to(dev)
    gt = exact_ids(q0, x_all, live, all_ids)
    launches = {}
    serving_qps = st["graph_serving_qps"]
    for dp, shard in GRID_SHAPES:
        mesh = grid(dp, shard)
        zero_launches()
        snap = db.engine.snapshot()
        try:
            t0 = time.perf_counter()
            ses = ShardedEngineSearcher(snap, mesh, db.engine.options.metric, db.engine.pk)
            build_s = time.perf_counter() - t0
            for steps in (0, 2):
                got, dist = ses.search(q_np, K, refine_steps=steps)
                check(got.shape == (BATCH, K) and np.isfinite(dist).all(),
                      f"sharded engine {dp}x{shard} refine {steps}: shape/finite")
                check(not np.isin(got, deleted).any(), "sharded engine: a deleted id was returned")
                check(_fresh_rows(got, dist, q0, x_all, all_ids, upd),
                      "sharded engine: a stale row of an updated id was returned")
                recall = recall_of(got, gt)
                qps, lo, hi = timed_qps(lambda: ses.search(q_np, K, refine_steps=steps), BATCH)
                if st["profile"] and steps == 0 and (dp, shard) == GRID_SHAPES[0]:
                    profile_batch(None, None, None, "sharded engine plane", card,
                                  run=lambda: ses.search(q_np, K))
                print(f"sharded engine plane, {grid_line(mesh)}, refine_steps {steps}: recall@10 "
                      f"{recall:.5f} against the exact visible answer ({len(upd)} updated ids, "
                      f"{len(deleted)} deleted); {qps:.0f} QPS (range {lo:.0f}-{hi:.0f}) beside "
                      f"the graph phase's one-device serving {serving_qps:.0f} QPS; searcher "
                      f"built in {build_s:.3f} s [{card}]", flush=True)
                check(recall >= GRAPH_RECALL_FLOOR,
                      f"sharded engine {dp}x{shard} refine {steps}: recall {recall}")
        finally:
            snap.release()
        part = launch_counts()
        print(f"sharded engine plane {mesh.shape} launches {part} [{card}]", flush=True)
        for name, n in part.items():
            check(n > 0, f"the sharded engine plane launched {name}")
        add_launches(launches, part)
        del ses
    torch.cuda.empty_cache()
    return launches


def _fresh_rows(got, dist, q, x_all, all_ids, upd) -> bool:
    """Every updated id in the results sits at its new vector's distance."""
    for b, j in zip(*np.nonzero(np.isin(got, upd))):
        v = x_all[int(np.searchsorted(all_ids, got[b, j]))]
        want = float(((q[b] - v) ** 2).sum())
        if abs(float(dist[b, j]) - want) > GRID_REL_TOL * max(1.0, want):
            return False
    return True


def grid_build_phase(st, card):
    """Phase 9d-g: sharded_kmeans_step over the flat phase's 1,048,576 rows
    at 1,024 centres against a one-entry grid's step; build_graph_clustered
    over the same rows on the grid against the one-device build; then
    entry.dryrun_multichip(4) and every example's main(device="cuda")."""
    import contextlib
    import importlib
    import io

    from vecgo_tpu_torch.entry import dryrun_multichip
    from vecgo_tpu_torch.index.build_fast import build_graph_clustered
    from vecgo_tpu_torch.ops import beam as beam_ops
    from vecgo_tpu_torch.parallel.mesh import make_mesh, sharded_kmeans_step, split_rows

    dev = torch.device("cuda")
    mesh = grid(1, GRID_SHARDS)
    x = st["x1"]
    launches = {}
    # 9d: one Lloyd step.
    c0 = torch.from_numpy(x[:KMEANS_K]).to(dev)
    out = {}
    for name, m in (("grid", mesh), ("one entry", make_mesh(devices=["cuda:0"]))):
        shards = split_rows(x, m)
        step = sharded_kmeans_step(m)
        step(shards, c0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c, inertia = step(shards, c0)
        torch.cuda.synchronize()
        out[name] = (c, float(inertia), time.perf_counter() - t0)
        del shards
    (c_g, in_g, t_g), (c_1, in_1, t_1) = out["grid"], out["one entry"]
    c_err = float((c_g - c_1).abs().max()) / float(c_1.abs().max())
    in_err = abs(in_g - in_1) / in_1
    print(f"sharded k-means step over {N} x {DIM} rows, {KMEANS_K} centres, grid {mesh.shape}: "
          f"{t_g * 1e3:.3f} ms against {t_1 * 1e3:.3f} ms on a one-entry grid; centres within "
          f"{c_err:.2e} of the largest, inertia {in_g:.6e} within {in_err:.2e} (tolerance "
          f"{KMEANS_REL_TOL}) [{card}]", flush=True)
    check(c_err <= KMEANS_REL_TOL and in_err <= KMEANS_REL_TOL, "sharded k-means step")
    # 9e: the clustered build on the grid against one device.
    graphs = {}
    for name, kw in (("grid", {"mesh": mesh}), ("one device", {"device": "cuda"})):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g, medoid, ecent, enodes = build_graph_clustered(x, **kw)
        graphs[name] = (g, (medoid, ecent, enodes), time.perf_counter() - t0)
    g_sh, entries_sh, t_sh = graphs["grid"]
    g_1, entries_1, t_1 = graphs["one device"]
    check(g_sh.shape == g_1.shape == (N, g_1.shape[1]), "grid build: shape")
    check(not (g_sh == np.arange(N)[:, None]).any() and g_sh.max() < N,
          "grid build: no self-loop, every id < n")
    deg_sh, deg_1 = (g_sh >= 0).sum(1).mean(), (g_1 >= 0).sum(1).mean()
    xd = torch.from_numpy(x).to(dev)
    rn = (xd * xd).sum(1)
    x16 = xd.to(torch.bfloat16)
    qb = xd[np.random.default_rng(23).choice(N, GRID_BUILD_QUERIES, replace=False)]
    gt = exact_ids(qb, xd, np.ones(N, bool), np.arange(N))

    def beam_recall(g, entries):
        # IVF-guided entries, as the segment's graph walk takes them: the
        # nodes of the 4 nearest entry centroids, and the medoid.
        medoid, ecent, enodes = entries
        cd = torch.cdist(qb, torch.from_numpy(ecent).to(dev))
        near = torch.from_numpy(enodes).to(dev).long()[cd.topk(4, largest=False).indices]
        start = torch.cat([near, torch.full((len(qb), 1), int(medoid), device=dev)], 1)
        _, ids = beam_ops.beam_search(qb, x16, rn, torch.from_numpy(g).to(dev), start, ef=64,
                                      k=K, beam_width=4)
        return recall_of(ids.cpu().numpy(), gt)

    r_sh, r_1 = beam_recall(g_sh, entries_sh), beam_recall(g_1, entries_1)
    print(f"build_graph_clustered over {N} x {DIM} rows: on the grid {mesh.shape} {t_sh:.3f} s, "
          f"on one device {t_1:.3f} s; mean degree {deg_sh:.3f} against {deg_1:.3f}; beam "
          f"recall@10 (ef 64, the 4 nearest entry nodes and the medoid, {GRID_BUILD_QUERIES} "
          f"queries) {r_sh:.5f} against {r_1:.5f}; "
          f"{int((g_sh != g_1).any(1).sum())} rows differ [{card}]", flush=True)
    check(deg_sh >= 0.8 * deg_1, "grid build: mean degree")
    check(r_sh >= r_1 - 0.05, f"grid build: beam recall {r_sh} against {r_1}")
    del xd, x16, rn, graphs
    torch.cuda.empty_cache()
    # 9f-g: the dry run and the examples.
    zero_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        dryrun_multichip(GRID_SHARDS)
    part = launch_counts()
    print(f"{buf.getvalue().strip().splitlines()[-1]} ({time.perf_counter() - t0:.3f} s, "
          f"launches {part}) [{card}]", flush=True)
    for name, n in part.items():
        check(n > 0, f"dryrun_multichip launched {name}")
    add_launches(launches, part)
    zero_launches()
    for name in EXAMPLES:
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            importlib.import_module(f"vecgo_tpu_torch.examples.{name}").main(device="cuda")
        lines = buf.getvalue().strip().splitlines()
        check(len(lines) > 0, f"example {name} printed nothing")
        print(f"example {name}: {time.perf_counter() - t0:.3f} s, last line: {lines[-1][:160]}",
              flush=True)
    part = launch_counts()
    print(f"examples on the card: launches {part} [{card}]", flush=True)
    check(part["scan_topk"] > 0, "the examples launched scan_topk")
    add_launches(launches, part)
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="print a torch.profiler breakdown of a flat, a graph, a quantized, "
                         "a streamed, a hybrid and a sharded batch")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from vecgo_tpu_torch.kernels import _build

    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"triton {'present' if importlib.util.find_spec('triton') else 'absent'}")
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True)
    print(nvcc.stdout.strip().splitlines()[-1])
    t0 = time.perf_counter()
    _build.library()
    print(f"kernel build {time.perf_counter() - t0:.1f} s", flush=True)

    rng = np.random.default_rng(args.seed)
    # The engine's shapes: the segment's bf16 pool scan at k + 8 (clean) and
    # at the churn margin's pool, the memtable's f32 chunks at its pools,
    # wide f32 rows, k 256, and pools past 256.
    cases = [
        kernel_case("segment-k18", rng, BATCH, N, DIM, 18, torch.bfloat16, "l2", 0, card, "short"),
        kernel_case("segment-k82", rng, BATCH, N, DIM, 82, torch.bfloat16, "l2", 0, card, "short"),
        # The short product at a depth that is not a multiple of 64 (96: the
        # second chunk half zeros), and at the deepest table it takes (256,
        # the plan's crossover to the deep product).
        kernel_case("segment-d96-k18", rng, BATCH, N, 96, 18, torch.bfloat16, "l2", 0, card,
                    "short", on_device=True),
        kernel_case("crossover-d256-k18", rng, BATCH, N // 2, 256, 18, torch.bfloat16, "l2", 0,
                    card, "short", on_device=True),
        kernel_case("chunk-pool74", rng, BATCH, 8192, DIM, 74, torch.float32, "l2", 0.3, card,
                    "f32"),
        kernel_case("chunk-pool82", rng, BATCH, 8192, DIM, 82, torch.float32, "l2", 0, card,
                    "f32"),
        kernel_case("wide-d768", rng, BATCH, 65536, 768, 10, torch.float32, "cos", 0, card, "f32"),
        kernel_case("k256", rng, BATCH, 65536, DIM, 256, torch.bfloat16, "l2", 0.1, card),
        # The deep bf16 product: 3,072-d rows (query tile never resident) and
        # the dbpedia-openai-1M shape (1,536-d) at a pool of 100; the f32
        # product over the 1M x 128 rows that ShardedFlat splits.
        kernel_case("deep-d3072", rng, BATCH, 262144, 3072, 10, torch.bfloat16, "l2", 0, card,
                    "deep", on_device=True),
        kernel_case("deep-d1536-k100", rng, BATCH, 1_000_000, 1536, 100, torch.bfloat16, "cos", 0,
                    card, "deep", on_device=True),
        kernel_case("f32-1M", rng, BATCH, N, DIM, 10, torch.float32, "l2", 0, card, "f32",
                    on_device=True),
        # Pools past 256: a coarse quantizer's pool of 1,000 over the segment
        # and over one decoded block, and k = 4096.
        kernel_case("segment-k1000", rng, BATCH, N, DIM, 1000, torch.bfloat16, "l2", 0, card),
        kernel_case("block-k1000", rng, BATCH, BLOCK_ROWS, DIM, 1000, torch.bfloat16, "l2", 0,
                    card),
        kernel_case("k4096", rng, BATCH, 65536, DIM, 4096, torch.bfloat16, "l2", 0.1, card),
        # The f32 product past 256: a memtable chunk at a k = 300 query's pool.
        kernel_case("chunk-k308", rng, BATCH, 8192, DIM, 308, torch.float32, "l2", 0, card,
                    "f32"),
        kernel_case("chunk-k1000", rng, BATCH, 8192, DIM, 1000, torch.float32, "l2", 0, card,
                    "f32"),
        # The FMA f32 product: memtable chunks TMA cannot read, a view that
        # starts mid-row and GloVe-50's rows (d % 4 != 0).
        kernel_case("chunk-view-fma", rng, BATCH, 8192, DIM, 82, torch.float32, "l2", 0, card,
                    "f32-fma", offset=1),
        kernel_case("chunk-d50-fma", rng, BATCH, 8192, 50, 82, torch.float32, "l2", 0.3, card,
                    "f32-fma"),
    ]
    main_case = cases[0]
    torch.cuda.empty_cache()
    st = engine_phase(args, card)
    grid_launches = sharded_flat_phase(st, card)
    seg, graph_launches = graph_phase(st, card)
    add_launches(grid_launches, sharded_engine_phase(st, seg, card))
    coded = [coded_case(seg, st["queries"][1], rng, *case, card) for case in CODED_CASES]
    compact_launches, compact_case = compact_phase(st, seg, rng, card)
    coded.append(compact_case)
    # The memtable's rows become a segment, so the reopened database of the
    # streamed case holds every row the graph phase searched.
    st["db"].commit()
    st["db"].close()
    seg.release_device()
    del seg
    st.pop("db")
    st.pop("x_all")
    torch.cuda.empty_cache()
    tier_launches, tier_cases = tiers_phase(st, card)
    cases += tier_cases
    cached_launches, cached_cases = cached_phase(st, np.random.default_rng(args.seed + 6), card)
    coded += cached_cases
    torch.cuda.empty_cache()
    beam_launches, beam_case = beam_phase(st, card)
    coded.append(beam_case)
    torch.cuda.empty_cache()
    hybrid_launches, hybrid_cases = hybrid_phase(st, card)
    cases += hybrid_cases
    add_launches(grid_launches, grid_build_phase(st, card))

    print(json.dumps({"kernels": [{
        "name": "scan_topk",
        "route": "cuda",
        "source": "vecgo_tpu_torch/csrc/scan_topk.cu",
        "replaces": "vecgo_tpu/ops/pallas_scan.py:141",
        "launches": (st["launches"] + graph_launches["scan_topk"] + sum(tier_launches.values())
                     + cached_launches["scan_topk"] + compact_launches["scan_topk"]
                     + beam_launches["scan_topk"] + hybrid_launches
                     + grid_launches["scan_topk"]),
        "launches_by_path": {"flat": st["launches"], "graph": graph_launches["scan_topk"],
                             "compact": compact_launches["scan_topk"], **tier_launches,
                             "cached": cached_launches["scan_topk"],
                             "beam": beam_launches["scan_topk"], "hybrid": hybrid_launches,
                             "grid": grid_launches["scan_topk"]},
        "max_abs_err": max(c["err"] for c in cases),
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "share": main_case["bound_ms"] / main_case["ms"],
        "library_ms": None,
        "cases": {c["name"]: {k: c[k] for k in ("product", "ms", "bound_ms", "bound_by", "share",
                                                 "plain_ms", "route_ms", "mm_ms",
                                                 "fma_bound_ms") if k in c}
                  for c in cases},
    }, {
        "name": "coded_group_scan",
        "route": "cuda",
        "source": "vecgo_tpu_torch/csrc/coded_group_scan.cu",
        "replaces": "vecgo_tpu/ops/pallas_scan.py:247",
        "launches": (graph_launches["coded_group_scan"] + compact_launches["coded_group_scan"]
                     + cached_launches["coded_group_scan"] + beam_launches["coded_group_scan"]
                     + grid_launches["coded_group_scan"]),
        "launches_by_path": {"graph": graph_launches["coded_group_scan"],
                             "compact": compact_launches["coded_group_scan"],
                             "cached": cached_launches["coded_group_scan"],
                             "beam": beam_launches["coded_group_scan"],
                             "grid": grid_launches["coded_group_scan"]},
        "max_abs_err": max(c["err"] for c in coded),
        "ms": coded[0]["ms"],
        "plain_ms": coded[0]["plain_ms"],
        "bound_ms": coded[0]["bound_ms"],
        "bound_by": coded[0]["bound_by"],
        "share": coded[0]["bound_ms"] / coded[0]["ms"],
        "library_ms": None,
        "cases": {c["name"]: {k: c[k] for k in ("ms", "bound_ms", "bound_by", "plain_ms",
                                                 "bound_ms_all_slots", "bound_ms_all_clusters",
                                                 "code_tbps")}
                  for c in coded},
    }]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
