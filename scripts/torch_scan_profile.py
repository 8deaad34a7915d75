#!/usr/bin/env python3
"""Where `scan_topk`'s short product (or, with --f32, its split f32 product;
with --columns the BM25 sweep's sparse product, `scan_topk_columns`)
spends its time, on one CUDA card, by instrumented builds of this tree's
kernel.

    python3 scripts/torch_scan_profile.py [--seed 0] [--reps 5] [--variants a,b] [--f32 | --columns]

The card's profilers (ncu, nsys) are not available to this repository's
runs, so the short product is taken apart by builds: each variant is a copy
of `vecgo_tpu_torch/` under `build/scan_profile/<variant>/` with a few
source lines replaced (each replacement must match exactly once, so a
variant that no longer fits the kernel fails loudly), built by its own
`_build` in a process of its own. Every variant counts, in two device
counters, the warp passes whose vote found a survivor (the rare path:
exact scores, pushes, compactions) and the pool compactions (of every
product: the short product's alone run in these shapes). Variants:

- built: the kernel as it is (plus the counters);
- no-score: the score pass skipped (the TMA ring, the products and the
  turns alone); a compare that never holds reads the products' first sum,
  since ptxas drops every `wgmma` whose sums nothing reads;
- fast-only: the fast test and the vote run, the rare path never does (it
  stays in the build behind a condition the compiler cannot fold: compiled
  out, it took the fast test with it and then the products, PERF.md);
- no-bound: each split keeps its own threshold, nothing shared;
- two-wg: two consumer warpgroups at every depth and k (the plan gives
  three up to d = 192 and k = 64);
- bound-late: the shared bounds loaded in the tile that uses them, not a
  tile ahead.

With --f32 the split f32 product's variants (F32_VARIANTS):

- built: as it is;
- fast-only: the fast test and the vote run, the rare path never does (the
  built time less this is what the rare passes cost);
- no-score: the score pass skipped (the ring, the split, the three passes;
  the products' first sum read as in the short product's);
- no-split: the splitter warps write no low parts (they only wait and
  release), so the low-part pass multiplies whatever the buffer holds;
- big-only: the two small passes skipped (one tf32 pass, the product of a
  1xTF32 scan);
- one-wg: the second consumer warpgroup multiplies and scores nothing (it
  releases each stage as it lands), so each staged chunk serves 64 queries,
  the reuse of a one-warpgroup design; half the queries come back empty;
- ring-only: no products, no low parts, no score pass: the TMA ring and
  the splitters' and the consumers' barriers alone (the feed's own rate);
- timeline, timeline-fast-only, timeline-no-score: built, fast-only and
  no-score with clock64 read by warp 0 of each consumer warpgroup at each
  tile's start, before its score pass and after it, and around each
  chunk's stage waits, issue and wait for the tensor cores: the mean
  clocks of a warpgroup's tile in its products (the chunks issued, retired
  and added, with every wait for a stage) and in its score pass, and the
  products' share in stage waits (TMA landed; low parts written), issues
  and tensor waits (the reads add 2-3% to the scan).

With --columns the sparse product's variants (COLUMN_VARIANTS; its own
counters: warp slots whose vote found a survivor, and compactions):

- built: as it is;
- no-score: the scoring skipped (the ring, the transposition, the barrier);
- no-transpose: the transposition skipped (the scoring reads whatever the
  column-major buffer holds);
- no-conflict: each lane reads the column position of its lane number, not
  its query's (consecutive chunks: no bank conflict; the cost of the
  conflicts is the difference);
- fast-only: the fast test and the vote run, the rare path never does;
- ring-only: the ring alone (no transposition, no scoring, no bound reads:
  the rate at which the producer's bulk copies stream the table);
- no-bound: the shared bounds never read (each split its own).

Shapes: 4096 clustered queries over clustered l2 rows (1,048,576 rows, or
524,288 at d 256; chip_smoke.py's generator, made on the card from
--seed) at (d, k) in SHAPES; with --f32 the f32 cases of chip_smoke.py
(F32_SHAPES: the 1M x 128 scan ShardedFlat splits, cos rows at d 768, the
memtable chunk at pools 82 and 308) and the flat segment's scan of
benchport's exact cell (9,990,000 x 96 cos rows at a pool of 116) and one
of its memtable chunks (8,192 such rows); with
--columns the sweep of
`scripts/torch_scan_ab.py`'s "bm25-columns" case (4096 queries of 3
zipf-drawn columns over 1,049,576 BM25-like rows x 4096, 0.1% dead, k 36),
and the same with 3 uniformly drawn columns a query. Each prints its time (CUDA events over --reps
launches after a warm-up), the rare passes (and their share of all warp
passes), the compactions and the device time of each kernel
(torch.profiler over two launches), with the card's name and power limit,
then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 4096
SHAPES = ((128, 18), (128, 1), (128, 64), (128, 82), (128, 256), (128, 1000), (256, 18))

# Rare passes, compactions, and a timeline variant's clocks and tiles.
_DECLARE = ("__device__ unsigned long long g_rare = 0, g_comp = 0, g_mul = 0, g_score = 0, "
            "g_tiles = 0, g_full = 0, g_split = 0, g_issue = 0, g_wait = 0;")
_COUNT = [
    ("namespace {\n\nconstexpr int THREADS", "namespace {\n" + _DECLARE + "\nconstexpr int THREADS"),
    ("    if (!(vote0 | vote1)) continue;\n",
     "    if (!(vote0 | vote1)) continue;\n    if (lane == 0) atomicAdd(&g_rare, 1ull);\n"),
    ("    const int m = m0 + __ffs(todo) - 1;\n      todo &= todo - 1;\n      float t;",
     "    const int m = m0 + __ffs(todo) - 1;\n      todo &= todo - 1;\n"
     "      if (lane == 0) atomicAdd(&g_comp, 1ull);\n      float t;"),
    ('extern "C" {\n',
     'extern "C" {\nunsigned long long vecgo_profile_count(int which) {\n'
     '  unsigned long long v = 0, z = 0;\n'
     '  unsigned long long* c[] = {&g_rare, &g_comp, &g_mul, &g_score, &g_tiles, &g_full,'
     ' &g_split, &g_issue, &g_wait};\n'
     '  cudaMemcpyFromSymbol(&v, *c[which], 8);\n'
     '  cudaMemcpyToSymbol(*c[which], &z, 8);\n  return v;\n}\n'),
]
VARIANTS = {
    "built": [],
    # The products stay: a compare that never holds reads their first sum
    # (with nothing reading them, ptxas drops every wgmma but a dummy).
    "no-score": [("      if (scores) {",
                  "      if (acc[0] == -1.f && L.cap < 0) L.thr[0] = acc[0];\n"
                  "      if (scores && pm < 0.f) {")],
    "fast-only": [("    if (!(vote0 | vote1)) continue;\n",
                   "    if (!(vote0 | vote1) || L.cap > 0) continue;\n")],
    "no-bound": [("          th[h] = fminf(own[h], wsel::fval(key[h] + (key[h] < wsel::fkey(INFINITY))));\n"
                  "        short_score(L, acc, terms + (r.t % STERMS)",
                  "          th[h] = own[h];\n        short_score(L, acc, terms + (r.t % STERMS)")],
    "two-wg": [("constexpr int SHORT_WG3_MAX_K = 64;", "constexpr int SHORT_WG3_MAX_K = 0;")],
    "bound-late": [("    key[h] = next_key[h];\n"
                    "    next_key[h] = live[h] ? __ldcg(bound + qi[h]) : wsel::fkey(INFINITY);",
                    "    key[h] = live[h] ? __ldcg(bound + qi[h]) : wsel::fkey(INFINITY);")],
}


F32_SHAPES = {"f32-1M": (1 << 20, 128, 10, "l2"), "wide-d768": (65536, 768, 10, "cos"),
              "chunk-pool82": (8192, 128, 82, "l2"), "chunk-k308": (8192, 128, 308, "l2"),
              "exact-d96": (9_990_000, 96, 116, "cos"), "chunk-d96-pool116": (8192, 96, 116, "cos")}
_F32_NO_SCORE = ("short_score(L, tot, terms + (tiles % XSTERMS)",
                 "if (tot[0] == -1.f && L.cap < 0) L.thr[0] = tot[0];\n"
                 "        if (pm < 0.f) short_score(L, tot, terms + (tiles % XSTERMS)")
_F32_SCORE_CALL = ("        short_score(L, tot, terms + (tiles % XSTERMS) * XN, r_begin + t * XN, w, g, tg,"
                   " lane, qa,\n                    live, qi, own, th, pm, bound);\n")
# clock64 at a tile's start, before its score pass and after it, and
# around each chunk's waits for its stage (TMA landed, low parts written),
# its issue and its wait for the tensor cores, summed by warp 0 of each
# consumer warpgroup over its units.
_TIMELINE = [
    ("    float acc[64], tot[64];\n",
     "    float acc[64], tot[64];\n    unsigned long long s_mul = 0, s_score = 0, s_tiles = 0, "
     "s_full = 0, s_split = 0, s_issue = 0, s_wait = 0;\n"),
    ("        next_bounds(key, next_key, live, qi, bound);\n        chunk(0, tot);",
     "        const long long c0 = clock64();\n"
     "        next_bounds(key, next_key, live, qi, bound);\n        chunk(0, tot);"),
    (_F32_SCORE_CALL,
     "        const long long c1 = clock64();\n" + _F32_SCORE_CALL
     + "        s_mul += c1 - c0;\n        s_score += clock64() - c1;\n        ++s_tiles;\n"),
    ("        mbar_wait(smem_u32(full + r.s), r.ph);\n        mbar_wait(smem_u32(split + r.s), r.ph);\n",
     "        const long long k0 = clock64();\n        mbar_wait(smem_u32(full + r.s), r.ph);\n"
     "        const long long k1 = clock64();\n        mbar_wait(smem_u32(split + r.s), r.ph);\n"
     "        const long long k2 = clock64();\n"),
    ("        split_issue(dst, qh, ql, sb, sb + XCHUNK);\n        wgmma_wait<0>();\n",
     "        split_issue(dst, qh, ql, sb, sb + XCHUNK);\n        const long long k3 = clock64();\n"
     "        wgmma_wait<0>();\n        s_full += k1 - k0;\n        s_split += k2 - k1;\n"
     "        s_issue += k3 - k2;\n        s_wait += clock64() - k3;\n"),
    ("      if (lane < 16) L.pool_n[16 * w + lane] = L.cnt[16 * w + lane];\n",
     "      if (lane < 16) L.pool_n[16 * w + lane] = L.cnt[16 * w + lane];\n"
     "      if (lane == 0 && w == 0) {\n"
     + "".join(f"        atomicAdd(&g_{c}, s_{c});\n"
               for c in ("mul", "score", "tiles", "full", "split", "issue", "wait"))
     + "      }\n      s_mul = s_score = s_tiles = s_full = s_split = s_issue = s_wait = 0;\n"),
]
_F32_NO_SPLIT = ("                lo[e0 + b * step] = make_float4(",
                 "                if (N < 0) lo[e0 + b * step] = make_float4(")
F32_VARIANTS = {
    "built": [],
    "fast-only": VARIANTS["fast-only"],
    "no-score": [_F32_NO_SCORE],
    "no-split": [_F32_NO_SPLIT],
    "big-only": [
        ("    wgmma_m64n128k8_tf32(acc, dql + 2 * kk, dx + 2 * kk, kk > 0);", "    ;"),
        ("    wgmma_m64n128k8_tf32(acc, dqh + 2 * kk, dlo + 2 * kk, 1);", "    ;"),
        ("    wgmma_m64n128k8_tf32(acc, dqh + 2 * kk, dx + 2 * kk, 1);",
         "    wgmma_m64n128k8_tf32(acc, dqh + 2 * kk, dx + 2 * kk, kk > 0);"),
    ],
    "one-wg": [
        ("      if (qw0 >= B) {  // no live query: release each stage once it landed\n",
         "      if (qw0 >= B || cw == 1) {\n"
         "        if (lane < 16 && qw0 < B) pool_n[((size_t)u * 2 + cw) * 64 + 16 * w + lane] = 0;\n"),
    ],
    "ring-only": [_F32_NO_SCORE, _F32_NO_SPLIT,
                  ("        split_issue(dst, qh, ql, sb, sb + XCHUNK);",
                   "        if (N < 0) split_issue(dst, qh, ql, sb, sb + XCHUNK);")],
    "timeline": _TIMELINE,
    "timeline-fast-only": _TIMELINE + VARIANTS["fast-only"],
    "timeline-no-score": _TIMELINE + [_F32_NO_SCORE],
}


_COLUMN_COUNT = [
    ("namespace {\n\nconstexpr unsigned FULL", "namespace {\n" + _DECLARE + "\nconstexpr unsigned FULL"),
    ("          if (!__any_sync(FULL, pass[i])) continue;\n",
     "          if (!__any_sync(FULL, pass[i])) continue;\n"
     "          if (lane == 0) atomicAdd(&g_rare, 1ull);\n"),
    ("  Compacted c;\n  float thr;\n",
     "  Compacted c;\n  float thr;\n  if (lane == 0) atomicAdd(&g_comp, 1ull);\n"),
    _COUNT[-1],
]
COLUMN_VARIANTS = {
    "built": [],
    "no-score": [("        if (ga + w + s0 * NCW >= gb) break;\n        float a[4][R];",
                  "        if (ga + w + s0 * NCW >= gb || N > 0) break;\n        float a[4][R];")],
    "no-transpose": [("      transpose_stage<R>(ring + ring_at.s * rp,",
                      "      if (N < 0) transpose_stage<R>(ring + ring_at.s * rp,")],
    "no-conflict": [("sub_column<R>(a[i], tb, j < m[i] ? e[i][32 * j] : zp);",
                     "sub_column<R>(a[i], tb, (j < m[i] ? e[i][32 * j] & 0 : 0) | lane);")],
    "fast-only": [("pass[0] || pass[1] || pass[2] || pass[3])) continue;",
                   "pass[0] || pass[1] || pass[2] || pass[3]) || N > 0) continue;")],
    "ring-only": [("        if (ga + w + s0 * NCW >= gb) break;\n        float a[4][R];",
                   "        if (ga + w + s0 * NCW >= gb || N > 0) break;\n        float a[4][R];"),
                  ("      transpose_stage<R>(ring + ring_at.s * rp,",
                   "      if (N < 0) transpose_stage<R>(ring + ring_at.s * rp,"),
                  ("      if (t > 0 && (t % REFRESH == 0 ||", "      if (N < 0 && (t % REFRESH == 0 ||")],
    "no-bound": [("      if (t > 0 && (t % REFRESH == 0 ||", "      if (N < 0 && (t % REFRESH == 0 ||"),
                 ("      atomicMin(qbound, c.top);", "      if (k < 0) atomicMin(qbound, c.top);")],
}
# mode -> (source, variants, counters)
MODES = {"short": ("scan_topk.cu", VARIANTS, _COUNT),
         "f32": ("scan_topk.cu", F32_VARIANTS, _COUNT),
         "columns": ("scan_columns.cu", COLUMN_VARIANTS, _COLUMN_COUNT)}


def make_tree(name: str, mode: str = "short") -> str:
    """This tree's package with the variant's replacements (and the
    counters) under build/scan_profile/<name>/."""
    source, variants, count = MODES[mode]
    tag = "" if mode == "short" else mode + "-"
    dst = os.path.join(HERE, "build", "scan_profile", tag + name)
    if os.path.exists(dst):
        shutil.rmtree(dst)
    shutil.copytree(os.path.join(HERE, "vecgo_tpu_torch"), os.path.join(dst, "vecgo_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    src = os.path.join(dst, "vecgo_tpu_torch", "csrc", source)
    with open(src) as f:
        text = f.read()
    for old, new in count + variants[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old[:60]!r} matches {text.count(old)} times")
        text = text.replace(old, new)
    with open(src, "w") as f:
        f.write(text)
    return dst


def f32_shapes(torch, seed):
    """(name, q, x, xn, k, metric) of each F32_SHAPES case, made on the card."""
    dev = torch.device("cuda")
    for i, (name, (n, d, k, metric)) in enumerate(F32_SHAPES.items()):
        g = torch.Generator(device=dev).manual_seed(seed + i)
        centres = torch.randn((1024, d), generator=g, device=dev)
        x = centres[torch.randint(0, 1024, (n,), generator=g, device=dev)]
        x += 0.35 * torch.randn((n, d), generator=g, device=dev)
        q = centres[torch.randint(0, 1024, (B,), generator=g, device=dev)]
        q += 0.35 * torch.randn((B, d), generator=g, device=dev)
        if metric == "cos":
            x /= x.norm(dim=1, keepdim=True)
            q /= q.norm(dim=1, keepdim=True)
        yield name, q, x, (x * x).sum(1), k, metric


def column_shapes(torch, seed):
    """(name, cols, x, None, k, mask) of the BM25 sweep: torch_scan_ab.py's
    "bm25-columns" inputs, and the same table with uniformly drawn columns."""
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    from torch_scan_ab import CASES, make, query_columns

    n, h, k, _, metric, masked, kind = CASES["bm25-columns"]
    cols, x, _, mask = make(torch, seed, n, h, torch.bfloat16, metric, masked, kind)
    yield "sweep", cols, x, None, k, mask
    uniform = query_columns(torch, seed, h)
    g = torch.Generator(device=uniform.device).manual_seed(seed)
    uniform[:, :3] = torch.randint(0, h, (uniform.shape[0], 3), generator=g, device=uniform.device)
    yield "sweep-uniform", uniform, x, None, k, mask


def bf16_shapes(torch, seed):
    """(name, q, x, xn, k, metric) of each SHAPES case (bf16 rows), made on
    the card."""
    dev = torch.device("cuda")
    for i, (d, k) in enumerate(SHAPES):
        n = 1 << 20 if d <= 128 else 1 << 19
        g = torch.Generator(device=dev).manual_seed(seed + i)
        centres = torch.randn((1024, d), generator=g, device=dev)
        x = centres[torch.randint(0, 1024, (n,), generator=g, device=dev)]
        x += 0.35 * torch.randn((n, d), generator=g, device=dev)
        q = centres[torch.randint(0, 1024, (B,), generator=g, device=dev)]
        q += 0.35 * torch.randn((B, d), generator=g, device=dev)
        xn = (x * x).sum(1)
        yield f"d{d} k{k}", q, x.bfloat16(), xn, k, "l2"


def worker(root: str, seed: int, reps: int, mode: str = "short") -> None:
    sys.path.insert(0, root)
    import ctypes

    import torch
    from torch.profiler import ProfilerActivity, profile

    from vecgo_tpu_torch.kernels import _build
    from vecgo_tpu_torch.ops import scan_topk as st

    lib = _build.library()
    lib.vecgo_profile_count.restype = ctypes.c_ulonglong
    lib.vecgo_profile_count.argtypes = [ctypes.c_int]
    dev = torch.device("cuda")
    out = {}
    shapes = {"short": bf16_shapes, "f32": f32_shapes, "columns": column_shapes}[mode]
    for name, q, xb, xn, k, metric in shapes(torch, seed):
        n = xb.shape[0]

        def run():
            if mode == "columns":  # q: the columns, metric: the mask
                return st.scan_topk_columns(q, xb, k, metric)
            return st.scan_topk(q, xb, xn, k, metric)

        run()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            run()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / reps
        for which in range(9):
            lib.vecgo_profile_count(which)
        run()
        torch.cuda.synchronize()
        rare, comp, mul, score, tiles, *waits = (lib.vecgo_profile_count(which)
                                                 for which in range(9))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            run()
            torch.cuda.synchronize()
        kernels = {re.sub(r"^void |\(anonymous namespace\)::", "", ev.key)
                   .split("(")[0].split("<")[0].split("::")[-1][:32]: ev.device_time_total / 2e3
                   for ev in prof.key_averages() if ev.device_time_total > 0}
        # warp passes: 16 queries x 64 rows (short, f32); 32 queries x 4 rows (columns)
        passes = (B // 32) * (n // 4) if mode == "columns" else (B // 16) * (n // 64)
        out[name] = {"n": n, "ms": ms, "product": st.scan_topk.last_product,
                     "rare_passes": rare, "rare_share": rare / passes,
                     "compactions": comp, "kernels_ms": kernels}
        if tiles:  # a timeline variant: mean clocks of a warpgroup's tile
            out[name].update(tiles=tiles, products_clocks=mul / tiles, score_clocks=score / tiles,
                             chunk_clocks=[w / tiles for w in waits])
        del q, xb, xn
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--variants", help="comma-separated (default: every variant)")
    ap.add_argument("--f32", action="store_true", help="the split f32 product's variants")
    ap.add_argument("--columns", action="store_true",
                    help="the BM25 sweep's sparse product's variants")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    mode = "columns" if args.columns else "f32" if args.f32 else "short"
    if args.worker:
        worker(args.worker, args.seed, args.reps, mode)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_scan_profile: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    names = (args.variants or ",".join(MODES[mode][1])).split(",")
    trees = {name: make_tree(name, mode) for name in names}
    result = {"card": card, "variants": {}}
    for name, root in trees.items():
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", root,
                               "--seed", str(args.seed), "--reps", str(args.reps)]
                              + ({"f32": ["--f32"], "columns": ["--columns"]}.get(mode, [])),
                              capture_output=True, text=True, cwd=root)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            raise RuntimeError(f"variant {name} failed ({proc.returncode})")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        result["variants"][name] = res
        for shape, v in res.items():
            kern = ", ".join(f"{a} {b:.3f}" for a, b in v["kernels_ms"].items())
            print(f"scan profile {name} {shape} N={v['n']}: {v['product']} {v['ms']:.3f} ms, "
                  f"rare passes {v['rare_passes']} ({v['rare_share']:.2%}), compactions "
                  f"{v['compactions']}; device ms: {kern}"
                  + (f"; a tile's products {v['products_clocks']:.0f} and score pass "
                     f"{v['score_clocks']:.0f} clocks ({v['tiles']} tiles; a tile's stage waits, "
                     "issues and tensor waits " + " / ".join(f"{c:.0f}" for c in v["chunk_clocks"])
                     + ")" if "tiles" in v else "")
                  + f" [{card}]", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
