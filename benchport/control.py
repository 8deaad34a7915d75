#!/usr/bin/env python3
"""The control of a cell's correctness check: the plain reference put in the
program's place, computed one precision below what the configuration states
(TF32 products for float32 with TF32 off), answers every batch of the pool;
the judge then reads its numbers against the float32 reference. The limits
of `limits/<cell>.json` lie between these readings and the program's.

    python3 benchport/control.py --workload <cell> --seeds 1,2,3

prints one JSON line of numbers a seed, with each limit beside it. It runs
on the card at the cell's own size; `test_benchport_control.py` runs it on
the CPU at a small one. The benchmark's own runs never run it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def control_numbers(spec: dict, seed: int, device) -> dict:
    """The judge's numbers for the control's answers to every pool batch."""
    import torch

    from benchport import gen, judge
    from benchport import reference as R

    cfg, traffic = spec["config"], spec["traffic"]
    n, m, k = int(cfg["rows"]), int(cfg["memtable_rows"]), int(traffic["k"])
    inp = gen.make(cfg, traffic, seed, device)
    blocks = [(0, inp.base), (n, inp.tail)]
    deleted = torch.from_numpy(inp.deleted).to(device)
    visible = R.visible_mask(n + m, deleted, inp.meta, traffic.get("filter"), device)
    parts = []
    for q in inp.queries:
        d, ids = R.exact_topk(q, blocks, visible, k, cfg["metric"], precision="tf32")
        t = judge.truth(q, blocks, visible, k, cfg["metric"])
        parts.append((judge.judge_batch(q, ids.cpu().numpy(), d.cpu().numpy(), t, blocks,
                                        visible, deleted, cfg["metric"]), 1))
    return judge.combine(parts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    args = ap.parse_args(argv)

    import torch

    from benchport import judge, run

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    spec = run.load_spec(args.workload)
    print(run.card_line(torch, 1), file=sys.stderr, flush=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        nums = control_numbers(spec, seed, "cuda")
        chk = judge.checks(nums, spec["limits"])
        print(json.dumps({"workload": args.workload, "seed": seed, "control": "tf32",
                          "recall_at_k": nums["recall_at_k"], "fails": not judge.passed(chk),
                          "seconds": time.perf_counter() - t0, "checks": chk}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
