#!/usr/bin/env python3
"""`scan_topk` (kernel A) of this tree against another tree's, on one CUDA
card, at the shapes `chip_smoke.py` measures; and, with --sweep, where this
tree's products change over.

    python3 scripts/torch_scan_ab.py --other DIR [--seed 0] [--reps 3] [--sweep]

DIR holds another checkout of the repo (for example the parent commit
unpacked with `git archive`). Each tree runs in processes of its own (its
package imported from its root, its kernels built there by its own
`_build`), in the order other, this, this, other; every process makes the
same inputs on the card from --seed and times every case with CUDA events
over --reps launches after a warm-up. Cases: the segment's bf16 pool scan
(4096 x 1M x 128, k 18 and 82; at d 96; 524,288 x 256 at k 18, the deepest
table the short product takes), the memtable's f32 chunks (8,192 rows, k 74
with 30% masked and k 82), f32 cos at d 768, the f32 scan over 1M x 128
that ShardedFlat splits (k 10), the deep bf16 shapes (262,144 x 3,072 l2
k 10; 1M x 1,536 cos k 100) and the BM25 sweep (4096 x 1,049,576 x 4096,
sparse BM25-like rows of 12 weights, multi-hot queries of 3 columns, dot,
0.1% of rows dead, k 36) through the dense product, and the same sweep as
each tree's DeviceBM25 runs it ("bm25-columns": 3 zipf-drawn columns a
query, padded to 16 with -1, through `scan_topk_columns` where the tree has
it, else its multi-hot query through `scan_topk`); then pools past 256: k 1000
over the segment and over one 131,072-row block, k 4096 over 65,536 rows
(10% masked) and a memtable chunk at the pool of a k = 300 query (f32,
8,192 rows, k 308).

--sweep also times, in this tree alone, the bf16 products on the same
inputs (4096 queries, clustered l2 rows) at d 8-512 and k 1-1000: the short
product to d 256 (its plan, as the library gives it for an aligned table),
the deep product (driven past the plan's choice by the plan of a d = 4096
table) and, to d 128, the tile product (by the plan of an unaligned table);
the f32 products at d 32-768 and k 1-1000: the split product (its plan)
against the FMA product (the plan of an unaligned table), and the two at
d 128 over 8,192-262,144 rows at pools of 82-1000, where filling the pools
is most of the work (at 8,192 rows and k 1000 the FMA product measured
faster; PERF.md); the f32 chunk shape at each minimum of tiles a split (k 10, 82, 308); and the short
product's split minimum on probed-partition shapes (512 and 2,048 queries
over 8,192 and 34,304 rows at k 100, 64 queries over 8,192 and 131,072
rows), with the tile product on the same inputs. Prints one line
per case with the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 4096
# name: (n, d, k, table type, metric, masked share, kind of rows)
CASES = {
    "segment-k18": (1 << 20, 128, 18, "bf16", "l2", 0.0, "clustered"),
    "segment-k82": (1 << 20, 128, 82, "bf16", "l2", 0.0, "clustered"),
    "segment-d96-k18": (1 << 20, 96, 18, "bf16", "l2", 0.0, "clustered"),
    "crossover-d256-k18": (1 << 19, 256, 18, "bf16", "l2", 0.0, "clustered"),
    "chunk-pool74": (8192, 128, 74, "f32", "l2", 0.3, "clustered"),
    "chunk-pool82": (8192, 128, 82, "f32", "l2", 0.0, "clustered"),
    "wide-d768": (65536, 768, 10, "f32", "cos", 0.0, "clustered"),
    "f32-1M": (1 << 20, 128, 10, "f32", "l2", 0.0, "clustered"),
    "deep-d3072": (262144, 3072, 10, "bf16", "l2", 0.0, "clustered"),
    "deep-d1536-k100": (1_000_000, 1536, 100, "bf16", "cos", 0.0, "clustered"),
    "bm25-sweep": (1_049_576, 4096, 36, "bf16", "dot", 0.001, "bm25"),
    "bm25-columns": (1_049_576, 4096, 36, "bf16", "dot", 0.001, "bm25-columns"),
    "segment-k1000": (1 << 20, 128, 1000, "bf16", "l2", 0.0, "clustered"),
    "block-k1000": (131072, 128, 1000, "bf16", "l2", 0.0, "clustered"),
    "k4096": (65536, 128, 4096, "bf16", "l2", 0.1, "clustered"),
    "chunk-k308": (8192, 128, 308, "f32", "l2", 0.0, "clustered"),
}


def query_columns(torch, seed, h, b=B, words=3, t=16):
    """[b, t] int64 hot-term columns on the card as the device BM25
    snapshot encodes 3-word queries: `words` zipf(1.3) columns (hot columns
    are ordered by document frequency), -1 pads."""
    import numpy as np

    cols = np.full((b, t), -1, np.int64)
    cols[:, :words] = np.minimum(np.random.default_rng(seed).zipf(1.3, (b, words)) - 1, h - 1)
    return torch.from_numpy(cols).cuda()


def make(torch, seed, n, d, dtype, metric, masked, kind):
    """The case's inputs on the card: rows around 1,024 random centres
    (sigma 0.35, chip_smoke.py's generator), or BM25-like sparse rows (with
    multi-hot queries, or for "bm25-columns" the queries' columns as q)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    if kind.startswith("bm25"):
        x = torch.zeros((n, d), dtype=torch.bfloat16, device=dev)
        cols = torch.randint(0, d, (n, 12), generator=g, device=dev)
        vals = (torch.rand((n, 12), generator=g, device=dev) * 3).to(torch.bfloat16)
        x.scatter_(1, cols, vals)
        if kind == "bm25":
            q = torch.zeros((B, d), device=dev)
            q.scatter_(1, torch.randint(0, d, (B, 3), generator=g, device=dev), 1.0)
        else:
            q = query_columns(torch, seed, d)
        xn = None
    else:
        centres = torch.randn((1024, d), generator=g, device=dev)
        x = centres[torch.randint(0, 1024, (n,), generator=g, device=dev)]
        x += 0.35 * torch.randn((n, d), generator=g, device=dev)
        q = centres[torch.randint(0, 1024, (B,), generator=g, device=dev)]
        q += 0.35 * torch.randn((B, d), generator=g, device=dev)
        if metric == "cos":
            x /= x.norm(dim=1, keepdim=True)
            q /= q.norm(dim=1, keepdim=True)
        xn = (x * x).sum(1)
        x = x.to(dtype)
    mask = torch.rand(n, generator=g, device=dev) >= masked if masked else None
    return q, x, xn, mask


def time_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def worker(root, seed, reps, sweep):
    """Time every case with the tree at `root`; print one JSON line."""
    sys.path.insert(0, root)
    import torch

    from vecgo_tpu_torch.ops import scan_topk as st

    out = {}
    for i, (name, (n, d, k, tt, metric, masked, kind)) in enumerate(CASES.items()):
        dtype = torch.bfloat16 if tt == "bf16" else torch.float32
        q, x, xn, mask = make(torch, seed + i, n, d, dtype, metric, masked, kind)
        if kind == "bm25-columns" and hasattr(st, "scan_topk_columns"):
            def run():
                return st.scan_topk_columns(q, x, k, mask)
        else:
            if kind == "bm25-columns":  # a tree from before the sparse product: its multi-hot sweep
                c = q
                q = torch.zeros((c.shape[0], d), device=c.device)
                q.scatter_add_(1, c.clamp_min(0), (c >= 0).float())

            def run():
                return st.scan_topk(q, x, xn, k, metric, mask)
        ms = time_ms(torch, run, reps)
        out[name] = {"ms": ms, "product": getattr(st.scan_topk, "last_product", None)}
        del q, x, xn, mask
        torch.cuda.empty_cache()
    if sweep:
        out["sweep"] = sweep_products(torch, st, seed, reps)
    print(json.dumps(out), flush=True)


# The sweep's depths and pools.
SWEEP_D = (8, 16, 32, 64, 96, 128, 160, 192, 256, 384, 512)
SWEEP_K = (1, 18, 82, 256, 1000)
SWEEP_F32_D = (32, 64, 96, 128, 192, 256, 384, 512, 768)


def sweep_products(torch, st, seed, reps):
    """The short, tile and deep bf16 products and the split and FMA f32
    products by d and k, and the f32 chunk by split minimum (this tree's
    plans and split rule, driven past their choice)."""
    from vecgo_tpu_torch.kernels import _build

    lib, dev = _build.library(), torch.device("cuda")
    plan_of = st._plan
    rows = {}
    for d in SWEEP_D:
        n = 1 << 20 if d <= 128 else 1 << 19 if d <= 256 else 1 << 18
        q, x, xn, _ = make(torch, seed + d, n, d, torch.bfloat16, "l2", 0.0, "clustered")
        for k in SWEEP_K:
            plans = {"deep": plan_of(lib, dev, 1, 4096, k, 1)}
            own = plan_of(lib, dev, 1, d, k, 1)
            if own.product == "short":
                plans["short"] = own
            if d <= 128:
                plans["tile"] = plan_of(lib, dev, 1, d, k, 0)  # unaligned: the tile plan
            row = {}
            for name, plan in plans.items():
                st._plan = lambda *a, **kw: plan
                row[f"{name}_ms"] = time_ms(torch, lambda: st.scan_topk(q, x, xn, k, "l2"), reps)
                st._plan = plan_of
            row["plan"] = own.product
            rows[f"bf16 d{d} N{n} k{k}"] = row
        del q, x, xn
        torch.cuda.empty_cache()
    for d in SWEEP_F32_D:
        n = 1 << 20 if d <= 128 else 1 << 19 if d <= 256 else 1 << 18
        q, x, xn, _ = make(torch, seed + d, n, d, torch.float32, "l2", 0.0, "clustered")
        for k in SWEEP_K:
            plans = {"f32": plan_of(lib, dev, 0, d, k, 1), "f32-fma": plan_of(lib, dev, 0, d, k, 0)}
            row = {}
            for name, plan in plans.items():
                st._plan = lambda *a, **kw: plan
                row[f"{name}_ms"] = time_ms(torch, lambda: st.scan_topk(q, x, xn, k, "l2"), reps)
                st._plan = plan_of
            row["plan"] = plans["f32"].product
            rows[f"f32 d{d} N{n} k{k}"] = row
        del q, x, xn
        torch.cuda.empty_cache()
    for n in (8192, 16384, 65536, 262144):
        q, x, xn, _ = make(torch, seed + n, n, 128, torch.float32, "l2", 0.0, "clustered")
        for k in (82, 150, 256, 308, 512, 1000):
            plans = {"f32": plan_of(lib, dev, 0, 128, k, 1),
                     "f32-fma": plan_of(lib, dev, 0, 128, k, 0)}
            row = {}
            for name, plan in plans.items():
                st._plan = lambda *a, **kw: plan
                row[f"{name}_ms"] = time_ms(torch, lambda: st.scan_topk(q, x, xn, k, "l2"), reps)
                st._plan = plan_of
            st.scan_topk(q, x, xn, k, "l2")
            row["plan"] = st.scan_topk.last_product
            rows[f"f32 pools d128 N{n} k{k}"] = row
        del q, x, xn
        torch.cuda.empty_cache()
    chunk = {}
    floor = st._MIN_TILES_F32
    for k in (10, 82, 308):
        q, x, xn, _ = make(torch, seed + k, 8192, 128, torch.float32, "l2", 0.0, "clustered")
        for tiles in (4, 8, 16, 32, 64):
            st._MIN_TILES_F32 = tiles
            chunk[f"f32 chunk k{k} min_tiles {tiles}"] = time_ms(
                torch, lambda: st.scan_topk(q, x, xn, k, "l2"), reps)
        st._MIN_TILES_F32 = floor
    short = {}
    floor = st._MIN_TILES_SHORT
    # Probed partitions (a few hundred queries over a few thousand rows) and
    # a small batch over a block: the short product's split minimum.
    for b, n, k in ((512, 8192, 100), (2048, 34304, 100), (64, 8192, 100), (64, 131072, 18)):
        q, x, xn, _ = make(torch, seed + n + k, n, 128, torch.bfloat16, "l2", 0.0, "clustered")
        q = q[:b].contiguous()
        for tiles in (1, 2, 4, 8, 16, 32):
            st._MIN_TILES_SHORT = tiles
            short[f"short B{b} N{n} k{k} min_tiles {tiles}"] = time_ms(
                torch, lambda: st.scan_topk(q, x, xn, k, "l2"), reps)
        st._MIN_TILES_SHORT = floor
        tile = plan_of(lib, dev, 1, 128, k, 0)
        st._plan = lambda *a, **kw: tile
        short[f"short B{b} N{n} k{k} tile product"] = time_ms(
            torch, lambda: st.scan_topk(q, x, xn, k, "l2"), reps)
        st._plan = plan_of
    return {"products": rows, "chunk_splits": chunk, "short_splits": short}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="root of the other checkout")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker, args.seed, args.reps, args.sweep)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_scan_ab: no CUDA device", file=sys.stderr)
        return 2
    if not args.other:
        ap.error("--other is required")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    runs = {"other": [], "this": []}
    for who in ("other", "this", "this", "other"):
        root = os.path.abspath(args.other) if who == "other" else HERE
        cmd = [sys.executable, os.path.abspath(__file__), "--worker", root, "--seed",
               str(args.seed), "--reps", str(args.reps)]
        if args.sweep and who == "this" and not runs["this"]:
            cmd.append("--sweep")
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=root)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            raise RuntimeError(f"the {who} tree's worker failed ({proc.returncode})")
        runs[who].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    result = {"card": card, "cases": {}}
    for name, (n, d, k, tt, metric, masked, kind) in CASES.items():
        ms = {who: [r[name]["ms"] for r in runs[who]] for who in runs}
        mean = {who: sum(v) / len(v) for who, v in ms.items()}
        product = runs["this"][0][name]["product"]
        result["cases"][name] = {"other_ms": mean["other"], "this_ms": mean["this"],
                                 "runs": ms, "product": product}
        print(f"scan_topk {name}: B={B} N={n} d={d} k={k} {tt} {metric}"
              f"{f' mask {masked:.1%} out' if masked else ''} ({kind} rows): other tree "
              f"{mean['other']:.3f} ms {[round(v, 3) for v in ms['other']]}, this tree "
              f"({product} product) {mean['this']:.3f} ms {[round(v, 3) for v in ms['this']]}, "
              f"{mean['other'] / mean['this']:.2f}x [{card}]", flush=True)
    if args.sweep:
        sweep = runs["this"][0]["sweep"]
        result["sweep"] = sweep
        for key, v in sweep["products"].items():
            times = ", ".join(f"{p} {v[p + '_ms']:.3f} ms"
                              for p in ("short", "tile", "deep", "f32", "f32-fma")
                              if p + "_ms" in v)
            print(f"sweep {key}: {times}; the plan picks {v['plan']} [{card}]")
        for key, v in sweep["chunk_splits"].items():
            print(f"sweep {key}: {v:.3f} ms [{card}]")
        for key, v in sweep["short_splits"].items():
            print(f"sweep {key}: {v:.3f} ms [{card}]")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
