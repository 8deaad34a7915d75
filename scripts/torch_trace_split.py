#!/usr/bin/env python3
"""One cell of `benchport/` served with the port's own spans and counters
read (`vecgo_tpu_torch/engine/tracing.py`): where a batch's time goes inside
the planner and `_finish`, and what recording costs.

    python3 scripts/torch_trace_split.py --workload <cell> --seed <n> [--seconds 40]
        [--overhead PAIRS] [--no-trace] [--out DIR]

It builds and warms the cell's deployment as `benchport/run.py` does
(`benchport.drive`), the warm-up under a `tracing.recording()` of its own:
that is where a filtered plan builds its filter masks and gathers its
compact sub-corpus, which the plan cache then serves to the window. From it,
the plan's numbers: its sources' kinds, `filter.rows_admitted` of
`filter.rows_total`, `gather.rows` and `gather.bytes`, and the
`planner.filter` and `planner.gather` spans' ms. Then:

- the traced window (unless `--no-trace`): `torch.profiler`, benchport's
  `Probe` and a `tracing.recording()` at once. Prints the device's idle time
  by the innermost host span open, with the program's `vecgo.*` ranges among
  the probe's spans (benchport's own reduction), and from the recorder each
  span's and counter's mean a batch and the batch timeline:
  `queue_ms` (a batch's `planner.wait` start minus its `planner.dispatch`
  end), `wait_ms`, `decode_ms`, `compact_ms`, `merge_width`, and a masked
  memtable scan's `memtable.rows_scanned` and `memtable.rows_admitted`;
- `--overhead PAIRS`: untraced windows without and with a recorder
  installed, in turns (off, on, on, off, ...), each window's `qps` and
  `p95_batch_ms` as the benchmark reads them.

The whole result is written to `<DIR>/trace_split_<cell>_<seed>.json`
(`--out`, by default the git-ignored `build/trace_split`). It needs a CUDA
card. Once the benchmark reads the program's spans itself, this script has
no work left and goes.
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

PREFIX = "vecgo."


def program_events(prof, T):
    """The trace's events as benchport's reader classifies them, plus the
    program's `vecgo.*` ranges as spans under the reader's span prefix."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if (ev.is_user_annotation() and name.startswith(PREFIX)
                and not str(ev.device_type()).endswith("CUDA")):
            kind, name = "span", T.SPAN_PREFIX + name
        else:
            kind = T._classify(ev)
        if kind is not None:
            out.append(T.Event(kind, name, int(ev.start_ns()), int(ev.end_ns()),
                               int(ev.correlation_id()), int(ev.linked_correlation_id())))
    return out


def batch_numbers(rec) -> dict:
    """Means a batch over the recorder's batches: every span's host ms,
    every counter, and the queue, from the records alone."""
    spans, counts = defaultdict(lambda: defaultdict(float)), defaultdict(lambda: defaultdict(float))
    first = {}
    for s in rec.spans():
        spans[s.name][s.batch] += (s.t1_ns - s.t0_ns) / 1e6
        first.setdefault((s.name, s.batch), s)
    for c in rec.counts():
        counts[c.name][c.batch] += c.n
    batches = sorted({b for per in spans.values() for b in per})
    queue = []
    for b in batches:
        disp, wait = first.get(("planner.dispatch", b)), first.get(("planner.wait", b))
        if disp is not None and wait is not None:
            queue.append((wait.t0_ns - disp.t1_ns) / 1e6)
    widths = [c.n for c in rec.counts("merge.width")]

    def mean(per):
        return sum(per.values()) / len(batches) if batches else None

    return {
        "batches": len(batches),
        "dropped": rec.dropped,
        "queue_ms": statistics.mean(queue) if queue else None,
        "wait_ms": mean(spans["planner.wait"]),
        "decode_ms": mean(spans["finish.decode"]),
        "compact_ms": mean(spans["finish.compact"]),
        "merge_width": statistics.mean(widths) if widths else None,
        "span_ms": {n: mean(per) for n, per in sorted(spans.items())},
        "count": {n: mean(per) for n, per in sorted(counts.items())},
    }


PLAN_COUNTS = ("filter.rows_admitted", "filter.rows_total", "gather.rows", "gather.bytes")


def plan_numbers(rec) -> dict:
    """What the plans built under `rec` did: the kinds of source they
    scanned, the filter's admitted and total rows, the gathered rows and
    bytes (each summed over the plans), and the `planner.filter` and
    `planner.gather` spans' ms in all."""
    out = {name: sum(c.n for c in rec.counts(name)) if rec.counts(name) else None
           for name in PLAN_COUNTS}
    out["sources"] = sorted({s.name for s in rec.spans() if s.name.startswith("source.")})
    for name in ("planner.filter", "planner.gather"):
        out[name + "_ms"] = sum((s.t1_ns - s.t0_ns) / 1e6 for s in rec.spans(name))
    return out


def window_numbers(win) -> dict:
    from benchport import timeline

    done_t = [t for t, _, _ in win.done]
    return {"qps": timeline.qps(win.t0, done_t, [ids.shape[0] for _, ids, _ in win.done]),
            "p95_batch_ms": timeline.p95_ms([t for t, _ in win.pulls], done_t),
            "batches": len(win.done)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--overhead", type=int, default=0, help="pairs of untraced windows")
    ap.add_argument("--no-trace", action="store_true")
    ap.add_argument("--out", default=str(ROOT / "build" / "trace_split"))
    args = ap.parse_args(argv)

    import torch

    from benchport import drive, gen, run
    from benchport import trace as T
    from vecgo_tpu_torch.engine import tracing

    spec = run.load_spec(args.workload)
    cfg, traffic = spec["config"], spec["traffic"]
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    out = {"workload": args.workload, "seed": args.seed, "seconds": args.seconds,
           "device": run.card_line(torch, 1)}
    print(out["device"], file=sys.stderr, flush=True)

    t0 = time.perf_counter()
    inputs = gen.make(cfg, traffic, args.seed, "cuda").to_host()
    db, _ = drive.open_db(cfg, inputs, "cuda")
    with tracing.recording() as rec:
        drive.warm(db, traffic, inputs.queries, "cuda")
    out["plan"] = plan_numbers(rec)
    del rec
    gc.collect()
    gc.freeze()
    out["setup_s"] = time.perf_counter() - t0
    print(f"plan (warm-up): {json.dumps(out['plan'])}", file=sys.stderr, flush=True)

    if not args.no_trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with drive.Probe(), tracing.recording() as rec, profile(activities=acts) as prof:
            with record_function(T.WINDOW):
                win = drive.serve(db, traffic, inputs.queries, args.seconds)
                torch.cuda.synchronize()
        out["traced"] = dict(window_numbers(win), **batch_numbers(rec))
        tr = T.reduce(program_events(prof, T))
        out["traced"].update(busy_s=tr.busy_s, window_s=tr.window_s,
                             idle_gaps=sorted(tr.idle_by_span.items(), key=lambda kv: -kv[1]),
                             breakdown=tr.breakdown())
        del prof, rec
        t = out["traced"]
        print(f"traced: {t['batches']} batches, qps {t['qps']:.1f}, busy {t['busy_s']:.3f} of "
              f"{t['window_s']:.3f} s; queue {t['queue_ms']:.3f} ms, wait {t['wait_ms']:.3f}, "
              f"decode {t['decode_ms']:.3f}, compact {t['compact_ms']:.3f}, "
              f"width {t['merge_width']}; masked memtable rows scanned "
              f"{t['count'].get('memtable.rows_scanned')}, admitted "
              f"{t['count'].get('memtable.rows_admitted')}", file=sys.stderr)
        for name, s in t["idle_gaps"][:14]:
            print(f"  idle {name}: {s:.3f} s", file=sys.stderr)
        for name, ms in t["span_ms"].items():
            print(f"  span {name}: {ms:.3f} ms a batch", file=sys.stderr)
        for name, n in t["count"].items():
            print(f"  count {name}: {n:.3f} a batch", file=sys.stderr)

    windows = []
    for i in range(2 * args.overhead):
        on = i % 4 in (1, 2)  # off, on, on, off, ...
        if on:
            with tracing.recording() as rec:
                win = drive.serve(db, traffic, inputs.queries, args.seconds)
            n = len(rec.records)
            del rec
        else:
            win = drive.serve(db, traffic, inputs.queries, args.seconds)
            n = 0
        w = dict(window_numbers(win), recording=on, records=n)
        windows.append(w)
        print(f"window {i} recording {'on ' if on else 'off'}: qps {w['qps']:.1f}, "
              f"p95 {w['p95_batch_ms']:.2f} ms, {w['batches']} batches", file=sys.stderr,
              flush=True)
        del win
    if windows:
        out["windows"] = windows
        for on in (False, True):
            q = [w["qps"] for w in windows if w["recording"] == on]
            out[f"qps_median_{'on' if on else 'off'}"] = statistics.median(q)
        print(f"qps median off {out['qps_median_off']:.1f}, on {out['qps_median_on']:.1f}",
              file=sys.stderr)
    db.close()

    dest = Path(args.out) / f"trace_split_{args.workload}_{args.seed}.json"
    dest.parent.mkdir(parents=True, exist_ok=True)
    dest.write_text(json.dumps(out, indent=1, default=float))
    print(json.dumps({k: v for k, v in out.items() if k not in ("traced", "windows")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
