#!/usr/bin/env python3
"""Drive the PyTorch port's flat and graph engine paths once on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--profile]

1. Environment: card name and power limit, torch and CUDA versions, nvcc,
   Triton, and the seconds the kernels take to build from `vecgo_tpu_torch/csrc`
   (one nvcc per source, all started together).
2. Kernel phase: `scan_topk` against its plain PyTorch version on the card at
   the shapes the engine gives it (the segment scan at pools 18 and 82, f32
   memtable chunks at pools 74 and 82, wide rows), plus k = 256; each case
   prints its time beside its bound (the larger of operations over the
   card's peak for their type and bytes over 3.35 TB/s), its share of that
   bound, and the product alone through torch.mm (context only).
3. Flat engine phase: Open -> insert_batch (1M clustered 128-d rows with
   metadata) -> commit -> 50k more rows left in the memtable -> 1,000
   deletes -> search_arrays over 4096-query batches, unfiltered and at
   1/10/80% selectivity (QPS: the median of five windows of at least 1 s),
   plus one search_arrays_stream pass; recall@10 against the exact
   plain-PyTorch answer over the visible rows, deleted ids absent, every live
   id readable by get, and the kernel's launch count.
4. Graph engine phase, on the same database: commit the memtable, compact
   every segment into one Vamana segment (~1.1M live rows), delete 1,000
   more ids and insert 10k more rows, then search_arrays at the serving
   profile (ef=48, nprobes=4, no refine, no rescore), with one refine round
   and the pool rescore, at 10% selectivity (brute force over the codes) and
   at 80% (the graph with a mask), and one search_arrays_stream pass; recall@10
   against the exact answer over the visible rows (floor 0.95), deleted ids
   absent, every live id readable, both kernels launched by the path.
   Kernel B (`coded_group_scan`) is then held against its plain version on the
   segment's own table with the probe inversion of a real batch, at the
   serving profile (4 probes, kk 16) and at the segment's default knobs (20
   probes, kk 8, qcap 96) with 80% of the slots kept; each case prints its
   bound (probed clusters' bytes, bf16 peak) beside the all-clusters count
   (every cluster's bytes, fp32 peak: the count the first port used) and the
   code bytes' achieved TB/s.

With --profile, the flat phase's unfiltered case and the graph phase's
serving case also print a breakdown of one sync batch: its wall time (the
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
# Sync QPS: the median of QPS_WINDOWS windows of at least QPS_WINDOW_S each.
QPS_WINDOWS = 5
QPS_WINDOW_S = 1.0
# Two fp32 sums of the same products in different orders differ by a few ulp
# of the largest term: relative to |q|^2 + |x|^2, 2e-5 is ~170 ulp (fp32
# eps 1.2e-7), above the sqrt(d)-scaled rounding of a d <= 768 dot product.
REL_TOL = 2e-5
# Kernel B: relative to |q - c|^2 + |x^ - c|^2, the bound the CPU tests hold.
CODED_REL_TOL = 1e-4
# Published H100 SXM peaks at 700 W (NVIDIA data sheet): dense bf16 on the
# tensor cores, fp32 on the FMA units, HBM3.
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
HBM_BPS = 3.35e12


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


def bound(flop: float, nbytes: float, bf16_tensor: bool):
    """The least time the H100 could take for this work (ms) and what bounds
    it: operations over the peak rate of their type (989 TFLOP/s bf16 dense
    on the tensor cores, 67 TFLOP/s fp32 on the FMA units) against bytes over
    3.35 TB/s, each input read once and each output written once."""
    t_ops = flop / (PEAK_BF16 if bf16_tensor else PEAK_F32)
    t_mem = nbytes / HBM_BPS
    return (max(t_ops, t_mem) * 1e3, "operations" if t_ops >= t_mem else "bytes")


def mm_ms(q, xs) -> float:
    """The product alone through torch.mm on the same table in 64k-row
    blocks (context only: the port never calls it; no single PyTorch call
    computes the scan with its top-k)."""
    qc = q.to(xs.dtype)
    out = torch.empty((q.shape[0], 65536), dtype=xs.dtype, device=q.device)

    def run():
        for s in range(0, xs.shape[0], 65536):
            e = min(xs.shape[0], s + 65536)
            torch.mm(qc, xs[s:e].T, out=out[:, : e - s])

    return cuda_ms(run, reps=3)


def kernel_case(name, rng, b, n, d, k, dtype, metric, mask_frac, card):
    from vecgo_tpu_torch.ops.scan_topk import scan_topk, scan_topk_reference

    dev = torch.device("cuda")
    centers = rng.standard_normal((N_CLUSTERS, d)).astype(np.float32)
    x = torch.from_numpy(clustered(rng, n, centers)).to(dev)
    q = torch.from_numpy(clustered(rng, b, centers)).to(dev)
    if metric == "cos":
        x = x / x.norm(dim=1, keepdim=True)
        q = q / q.norm(dim=1, keepdim=True)
    xn = (x * x).sum(1)
    xs = x.to(dtype).contiguous()
    del x
    mask = None
    if mask_frac:
        mask = torch.from_numpy(rng.random(n) >= mask_frac).to(dev)
    args = (q, xs, xn, k, metric, mask)
    d_k, i_k = scan_topk(*args)
    d_r, i_r = scan_topk_reference(*args)
    torch.cuda.synchronize()
    qn = (q * q).sum(1)
    tol = REL_TOL * float(qn.max() + xn.max()) if metric == "l2" else REL_TOL * 4
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
        qq = q[bq].to(dtype).double()
        xx = xs[rows].double()
        dot = (qq * xx).sum(1)
        exact = {"l2": qn[bq].double() + xn[rows].double() - 2 * dot, "dot": -dot,
                 "cos": 1 - dot}[metric]
        gap = float((exact - d_r[bq, bj].double()).abs().max())
        check(gap <= 2 * tol, f"{name}: {int(bad.sum())} ids differ beyond ties (gap {gap})")
    if mask is not None:
        check(bool(mask[i_k[fin].long()].all()), f"{name}: a masked row was returned")
    ms = cuda_ms(lambda: scan_topk(*args), reps=5)
    plain_ms = cuda_ms(lambda: scan_topk_reference(*args), reps=1)
    mm = mm_ms(q, xs)
    nbytes = (b * d * 4 + n * d * xs.element_size() + n * 4 * (metric == "l2")
              + (n if mask is not None else 0) + b * k * 8)
    bound_ms, bound_by = bound(2.0 * b * n * d, nbytes, dtype == torch.bfloat16)
    print(f"kernel {name}: B={b} N={n} d={d} k={k} {str(dtype)[6:]} {metric}"
          f"{f' mask {mask_frac:.0%} out' if mask_frac else ''}: kernel {ms:.3f} ms, "
          f"bound {bound_ms:.3f} ms ({bound_by}), share {bound_ms / ms:.1%}, "
          f"plain {plain_ms:.3f} ms, torch.mm product alone {mm:.3f} ms, "
          f"max_abs_err {err:.3g} (tol {tol:.3g}), tie swaps {int(bad.sum())} [{card}]",
          flush=True)
    return {"name": name, "err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "mm_ms": mm}


def sync_qps(db, queries, kw) -> float:
    """QPS of back-to-back search_arrays calls over one window of QPS_WINDOW_S."""
    t0 = time.perf_counter()
    done = 0
    while (elapsed := time.perf_counter() - t0) < QPS_WINDOW_S:
        db.search_arrays(queries, k=K, **kw)
        done += len(queries)
    return done / elapsed


def profile_batch(db, queries, kw, label, card, reps=3):
    """Where one sync search_arrays batch spends its time: wall (median of 7
    sync batches), device busy (the union of the kernel and copy intervals
    that torch.profiler records over `reps` batches, per batch), the rest
    (host work and idle device), and the largest device items."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def batch():
        db.search_arrays(queries, k=K, **kw)
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
    db = vg.Open(vg.Memory(), vg.Create(dim=DIM, flush_threshold=2**62), device="cuda")
    t0 = time.perf_counter()
    ids1 = np.asarray(db.insert_batch(x1, metas1), np.int64)
    ingest_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    db.commit()
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
            "profile": args.profile}


def recall_vs_exact(got, q, x_all, visible, all_ids) -> float:
    """Recall@K of `got` against the exact plain-PyTorch answer over the
    visible rows."""
    from vecgo_tpu_torch.ops.scan_topk import scan_topk_reference

    xn = (x_all * x_all).sum(1)
    _, rows = scan_topk_reference(q, x_all, xn, K, "l2",
                                  torch.from_numpy(visible).to(x_all.device))
    gt = all_ids[rows.cpu().numpy()]
    return float(np.mean([len(set(g) & set(t)) / K for g, t in zip(got, gt)]))


def graph_phase(st, card):
    """Compact the flat phase's database into one Vamana segment and serve it."""
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
    return seg, launches


# Kernel B's two cases: (name, probes, kk, share of slots kept): the serving
# profile, and the segment's default knobs (ef 80 -> 20 probes, kk 8) under
# an 80% filter.
CODED_CASES = (("serving", 4, 16, 1.0), ("probes20", 20, 8, 0.8))


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
    from vecgo_tpu_torch.ops.coded_group_scan import (
        coded_group_scan, coded_group_scan_reference)

    dev = torch.device("cuda")
    t = seg.device_state(dev)["ivfq"]
    k_pad, s = t.bnorm2.shape
    q = torch.from_numpy(q_np).to(dev)
    b, d = q.shape
    args, qcap = coded_inputs(t, q, rng, n_probe, kk, keep)
    qtab, bn = args[1], args[3]
    d_k, i_k = coded_group_scan(*args)
    ref = coded_group_scan_reference(*args)
    torch.cuda.synchronize()
    err, tol, n_bad = coded_check(name, args, (d_k, i_k), ref)
    live = qtab < b
    ms = cuda_ms(lambda: coded_group_scan(*args), reps=20)
    plain_ms = cuda_ms(lambda: coded_group_scan_reference(*args), reps=2)
    # Work this batch needs: each live (cluster, query) pair scores the
    # cluster's S slots at d, bf16 x int8 products that are exact in bf16
    # (the tensor cores' bf16 peak); bytes: the codes, norms, scale and
    # centroid of each probed cluster once (an unprobed cluster needs none),
    # the queries and the probe table once, the outputs once.
    n_live = int(live.sum())
    probed = int(live.any(1).sum())
    code_bytes = probed * s * d
    out_bytes = d_k.numel() * 4 + i_k.numel() * 4
    nbytes = (code_bytes + probed * (s * 4 + 4 + d * 4) + q.numel() * 4 + qtab.numel() * 4
              + out_bytes)
    bound_ms, bound_by = bound(2.0 * n_live * s * d, nbytes, True)
    # The all-clusters count, for comparison with earlier records: every
    # cluster's codes and norms, fp32 peak.
    old_bytes = (t.codes.numel() + bn.numel() * 4 + t.scale.numel() * 4
                 + t.centroids.numel() * 4 + q.numel() * 4 + qtab.numel() * 4 + out_bytes)
    old_ms, old_by = bound(2.0 * n_live * s * d, old_bytes, False)
    per = torch.bincount(live.sum(1))
    print(f"kernel coded_group_scan {name}: B={b} K={k_pad} S={s} d={d} qcap={qcap} kk={kk} "
          f"probes={n_probe}{f' slots kept {keep:.0%}' if keep < 1 else ''} ({n_live} live "
          f"(cluster, query) pairs over {probed} probed clusters, at most "
          f"{per.shape[0] - 1} a cluster): kernel {ms:.3f} ms, bound {bound_ms:.3f} ms "
          f"({bound_by}), share {bound_ms / ms:.1%}; all-clusters bound {old_ms:.3f} ms "
          f"({old_by}), share {old_ms / ms:.1%}; codes read {code_bytes / 1e6:.1f} MB at "
          f"{code_bytes / (ms * 1e-3) / 1e12:.3f} TB/s; plain {plain_ms:.3f} ms, max_abs_err "
          f"{err:.3g} (tol {tol:.3g}), tie swaps {n_bad} [{card}]", flush=True)
    return {"name": name, "err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bound_ms_all_clusters": old_ms, "code_tbps":
            code_bytes / (ms * 1e-3) / 1e12}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="print a torch.profiler breakdown of a flat and a graph batch")
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
    # wide f32 rows, and the largest k the kernel takes.
    cases = [
        kernel_case("segment-k18", rng, BATCH, N, DIM, 18, torch.bfloat16, "l2", 0, card),
        kernel_case("segment-k82", rng, BATCH, N, DIM, 82, torch.bfloat16, "l2", 0, card),
        kernel_case("chunk-pool74", rng, BATCH, 8192, DIM, 74, torch.float32, "l2", 0.3, card),
        kernel_case("chunk-pool82", rng, BATCH, 8192, DIM, 82, torch.float32, "l2", 0, card),
        kernel_case("wide-d768", rng, BATCH, 65536, 768, 10, torch.float32, "cos", 0, card),
        kernel_case("k256", rng, BATCH, 65536, DIM, 256, torch.bfloat16, "l2", 0.1, card),
    ]
    main_case = cases[0]
    torch.cuda.empty_cache()
    st = engine_phase(args, card)
    seg, graph_launches = graph_phase(st, card)
    coded = [coded_case(seg, st["queries"][1], rng, *case, card) for case in CODED_CASES]
    st["db"].close()

    print(json.dumps({"kernels": [{
        "name": "scan_topk",
        "route": "cuda",
        "source": "vecgo_tpu_torch/csrc/scan_topk.cu",
        "replaces": "vecgo_tpu/ops/pallas_scan.py:141",
        "launches": st["launches"] + graph_launches["scan_topk"],
        "launches_by_path": {"flat": st["launches"], "graph": graph_launches["scan_topk"]},
        "max_abs_err": max(c["err"] for c in cases),
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "share": main_case["bound_ms"] / main_case["ms"],
        "library_ms": None,
        "cases": {c["name"]: {k: c[k] for k in ("ms", "bound_ms", "bound_by", "plain_ms",
                                                 "mm_ms")} for c in cases},
    }, {
        "name": "coded_group_scan",
        "route": "cuda",
        "source": "vecgo_tpu_torch/csrc/coded_group_scan.cu",
        "replaces": "vecgo_tpu/ops/pallas_scan.py:247",
        "launches": graph_launches["coded_group_scan"],
        "max_abs_err": max(c["err"] for c in coded),
        "ms": coded[0]["ms"],
        "plain_ms": coded[0]["plain_ms"],
        "bound_ms": coded[0]["bound_ms"],
        "bound_by": coded[0]["bound_by"],
        "share": coded[0]["bound_ms"] / coded[0]["ms"],
        "library_ms": None,
        "cases": {c["name"]: {k: c[k] for k in ("ms", "bound_ms", "bound_by", "plain_ms",
                                                 "bound_ms_all_clusters", "code_tbps")}
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
