#!/usr/bin/env python3
"""Kernel B (`coded_group_scan`) of this tree against another tree's, on one
CUDA card, on the same inputs.

    python3 scripts/torch_coded_ab.py --other DIR [--seed 0] [--reps 20]

DIR holds another checkout of the repo (for example an older commit
unpacked with `git archive`); its kernels are built there by its own
`vecgo_tpu_torch/kernels/_build.py` and its `vecgo_coded_group_scan` is
called through ctypes with the same C signature. Inputs: 1M clustered
128-d rows (1,024 Gaussian centres, sigma 0.35, as chip_smoke.py makes
them) in an overlap-2 membership of 3,008 clusters x 1,024 slots around
random rows, coded by `device_table_coded`; 4096 clustered queries. The
cases, their probe inversion and the check against the plain version are
chip_smoke.py's (`CODED_CASES`, `coded_inputs`, `coded_check`), and both
trees' outputs are held to it. Each case times other, this, this, other
(CUDA events over `--reps` launches after a warm-up) and prints one line
with the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as smoke  # noqa: E402

N, DIM, CENTRES, K, S, B = 1 << 20, 128, 1024, 3008, 1024, 4096


def other_library(root: str) -> ctypes.CDLL:
    """Build the other tree's kernels with its own `_build`; load its library."""
    code = ("import sys; sys.path.insert(0, '.'); from vecgo_tpu_torch.kernels import _build; "
            "print(_build.library()._name)")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, check=True)
    lib = ctypes.CDLL(out.stdout.strip().splitlines()[-1])
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.vecgo_coded_group_scan.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, p, p, p]
    lib.vecgo_coded_group_scan.restype = i
    if hasattr(lib, "vecgo_coded_group_scan_prepare"):  # trees that set the attribute once
        lib.vecgo_coded_group_scan_prepare.restype = i
        if lib.vecgo_coded_group_scan_prepare():
            raise RuntimeError("the other tree's kernel refused its shared memory")
    return lib


def table(rng, dev):
    from vecgo_tpu_torch.ops import ivf as ivf_ops

    centres = rng.standard_normal((CENTRES, DIM)).astype(np.float32)
    x = torch.from_numpy(smoke.clustered(rng, N, centres)).to(dev)
    cent = x[torch.from_numpy(rng.choice(N, K, replace=False)).to(dev)]
    cn = (cent * cent).sum(1)
    near = torch.cat([torch.topk(cn[None] - 2.0 * x[s:s + 65536] @ cent.T, 2, largest=False).indices
                      for s in range(0, N, 65536)])  # [N, 2] the two nearest clusters
    cl = near.reshape(-1)
    row = torch.arange(N, device=dev).repeat_interleave(2)
    order = torch.sort(cl, stable=True).indices
    cl, row = cl[order], row[order]
    start = torch.searchsorted(cl, torch.arange(K, device=dev))
    pos = torch.arange(2 * N, device=dev) - start[cl]
    keep = pos < S
    members = torch.full((K, S), -1, dtype=torch.int32, device=dev)
    members[cl[keep], pos[keep]] = row[keep].to(torch.int32)
    q = torch.from_numpy(smoke.clustered(rng, B, centres)).to(dev)
    return ivf_ops.device_table_coded(members, x), q


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="root of the other checkout")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_coded_ab: no CUDA device", file=sys.stderr)
        return 2
    from vecgo_tpu_torch.ops.coded_group_scan import coded_group_scan, coded_group_scan_reference

    card = smoke.card_line()
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    other = other_library(args.other)
    t, q = table(rng, dev)
    results = {}
    for name, n_probe, kk, keep in smoke.CODED_CASES:
        a, qcap = smoke.coded_inputs(t, q, rng, n_probe, kk, keep)
        o_d = torch.empty((K, qcap, kk), dtype=torch.float32, device=dev)
        o_i = torch.empty((K, qcap, kk), dtype=torch.int32, device=dev)

        def run_other():
            rc = other.vecgo_coded_group_scan(
                *(x.data_ptr() for x in a[:6]), B, K, qcap, S, DIM, kk, o_d.data_ptr(),
                o_i.data_ptr(), torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"other tree's launch failed: CUDA error {rc}")

        def run_this():
            return coded_group_scan(*a)

        run_other()
        out = run_this()
        ref = coded_group_scan_reference(*a)
        torch.cuda.synchronize()
        checked = {who: smoke.coded_check(f"{name} ({who} tree)", a, o, ref)
                   for who, o in (("other", (o_d, o_i)), ("this", out))}
        times = {"other": [], "this": []}
        for who in ("other", "this", "this", "other"):
            times[who].append(smoke.cuda_ms(run_other if who == "other" else run_this, args.reps))
        ms = {k: sum(v) / 2 for k, v in times.items()}
        live = a[1] < B
        probed = int(live.any(1).sum())
        per = int(live.sum(1).max())
        results[name] = {"other_ms": ms["other"], "this_ms": ms["this"], "runs": times,
                         "pairs": int(live.sum()), "probed": probed, "max_per_cluster": per,
                         "max_abs_err": {k: v[0] for k, v in checked.items()},
                         "tie_swaps": {k: v[2] for k, v in checked.items()}}
        print(f"coded_group_scan {name}: B={B} K={K} S={S} d={DIM} qcap={qcap} kk={kk} "
              f"probes={n_probe}{f' slots kept {keep:.0%}' if keep < 1 else ''}; "
              f"{int(live.sum())} pairs over {probed} probed clusters (at most {per} a "
              f"cluster): other tree {ms['other']:.4f} ms {times['other']}, this tree "
              f"{ms['this']:.4f} ms {times['this']}, {ms['other'] / ms['this']:.2f}x; this "
              f"reads {probed * S * DIM / (ms['this'] * 1e-3) / 1e12:.3f} TB/s of codes; "
              f"max_abs_err other {checked['other'][0]:.3g} this {checked['this'][0]:.3g} "
              f"(tol {checked['this'][1]:.3g}) [{card}]", flush=True)
    print(json.dumps({"card": card, "coded_ab": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
