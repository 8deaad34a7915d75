#!/usr/bin/env python3
"""Run one cell of the port's benchmark once on this machine's CUDA card.

    python3 benchport/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (`BENCHMARK.json` "workloads") names a configuration
(`benchport/configs/<config>.json`: the deployment) and a traffic mix
(`benchport/traffic/<mix>.json`); its limits are `benchport/limits/<cell>.json`
and each per-layer metric is read by `benchport/metrics/<metric>.py`.
A run makes the inputs on the card from the seed, builds the deployment
through the program's API, warms the cell's shapes (set-up, `setup_s`),
serves `--seconds` of traffic, reads the program's peak device memory, frees
the program, and judges every completed answer against the plain reference
(`judge.py`). With `--trace 1` the window runs under `torch.profiler` with
host spans around the port's layers, and the per-layer metrics are printed
in place of the end-to-end ones.

The last line of standard output is the result (one JSON object); the
numbers compared, each beside its limit, are the last lines of standard
error. Without a CUDA card, or with fewer cards than the cell asks for, it
exits with 2 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "benchport"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Caches of the program's builds, at fixed paths inside the checkout (the
# port's own kernels build into build/vecgo_tpu_torch/ there).
CACHE_DIRS = {
    "TORCH_EXTENSIONS_DIR": "build/torch_extensions",
    "TRITON_CACHE_DIR": "build/triton",
    "VECGO_NATIVE_CACHE": "build/vecgo_native",
}
# Top-level modules that must not be loaded: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "vecgo_tpu")


def load_spec(workload: str, root: Path = ROOT) -> dict:
    """The cell, its configuration, traffic mix, limits and metrics."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; cells: {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}

    def applies(metric):
        return workload in metric.get("workloads", [workload])

    return {
        "cell": cell,
        "config": json.loads((root / configs[cell["config"]]["file"]).read_text()),
        "traffic": json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text()),
        "limits": json.loads((HERE / "limits" / f"{workload}.json").read_text()),
        "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
        "per_layer": [m for m in bench["per_layer"] if applies(m)],
    }


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def card_line(torch, chips: int) -> str:
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        smi = "nvidia-smi unavailable"
    return (f"device: {torch.cuda.get_device_name(0)} x{chips} of "
            f"{torch.cuda.device_count()} [{smi}]; torch {torch.__version__}, "
            f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}")


@dataclass
class Record:
    """What a per-layer reader reads (`metrics/<name>.py`: `read(rec)`,
    returning a number or None where it finds nothing to read)."""

    config: dict
    traffic: dict
    batches: int  # batches completed in the window
    host: dict  # span -> [seconds of each call]
    scans: list  # every scan_topk call: span, b, n, d, k, table, masked
    trace: object  # trace.Trace, or None without a device trace
    commit_s: float


def read_metric(name: str, rec: Record):
    spec = importlib.util.spec_from_file_location(f"benchport_metric_{name}",
                                                  HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(rec)


def judge_window(spec: dict, seed: int, win, device) -> dict:
    """The compared numbers and recall over every completed batch, from the
    inputs made again from the seed."""
    import torch

    from benchport import gen, judge
    from benchport import reference as R

    cfg, traffic = spec["config"], spec["traffic"]
    n, m = int(cfg["rows"]), int(cfg["memtable_rows"])
    k = int(traffic["k"])
    inp = gen.make(cfg, traffic, seed, device)
    blocks = [(0, inp.base), (n, inp.tail)]
    deleted = torch.from_numpy(inp.deleted).to(device)
    visible = R.visible_mask(n + m, deleted, inp.meta, traffic.get("filter"), device)
    truths, parts = {}, []
    for (p, _), (ids, dists, count) in judge.distinct(win.done, win.pulls).items():
        if p not in truths:
            truths[p] = judge.truth(inp.queries[p], blocks, visible, k, cfg["metric"])
        parts.append((judge.judge_batch(inp.queries[p], ids, dists, truths[p], blocks, visible,
                                        deleted, cfg["metric"]), count))
    return judge.combine(parts)


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: float = T_START) -> dict:
    """One run of the cell: set-up, window, judgement. Returns the result."""
    import torch

    from benchport import drive, gen, judge, timeline
    from benchport import trace as T

    cfg, traffic, chips = spec["config"], spec["traffic"], int(spec["cell"]["chips"])
    cuda = torch.device(device).type == "cuda"
    stages = [("start", t_start)]
    inputs = gen.make(cfg, traffic, seed, device).to_host()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    stages.append(("imports and inputs", time.perf_counter()))
    db, commit_s = drive.open_db(cfg, inputs, device)
    stages.append(("deployment", time.perf_counter()))
    drive.warm(db, traffic, inputs.queries, device)
    gc.collect()
    gc.freeze()
    stages.append(("warm", time.perf_counter()))
    setup_s = stages[-1][1] - t_start
    print("setup: " + ", ".join(f"{name} {t - stages[i][1]:.3f} s" for i, (name, t)
                                in enumerate(stages[1:])) + f" (commit {commit_s:.3f} s)",
          file=sys.stderr, flush=True)

    probe, tr = None, None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with drive.Probe() as probe, profile(activities=acts) as prof:
            with record_function(T.WINDOW):
                win = drive.serve(db, traffic, inputs.queries, seconds)
                if cuda:
                    torch.cuda.synchronize()
        if cuda:
            t0 = time.perf_counter()
            events = T.from_profiler(prof)
            tr = T.reduce(events)
            print(f"trace: {T.kinds(events)}, {len(tr.kernels)} device operations "
                  f"({tr.unattributed} without a launch), read in "
                  f"{time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
        del prof
    else:
        win = drive.serve(db, traffic, inputs.queries, seconds)
    if cuda:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    db.close()
    del db, inputs
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    b = int(traffic["batch"])
    done_t = [t for t, _, _ in win.done]
    pulled_t = [t for t, _ in win.pulls]
    sizes = [ids.shape[0] for _, ids, _ in win.done]
    t0 = time.perf_counter()
    numbers = judge_window(spec, seed, win, device)
    print(f"judged {len(win.done)} batches in {time.perf_counter() - t0:.1f} s",
          file=sys.stderr, flush=True)
    e2e = {
        "qps": timeline.qps(win.t0, done_t, sizes),
        "p95_batch_ms": timeline.p95_ms(pulled_t, done_t),
        "recall_at_k": numbers["recall_at_k"],
        "peak_device_gib": peak / 2**30,
        "setup_s": setup_s,
    }
    metrics = {}
    if trace:
        rec = Record(cfg, traffic, len(win.done), dict(probe.host), list(probe.scans), tr,
                     commit_s)
        for m in spec["per_layer"]:
            value = read_metric(m["name"], rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in spec["end_to_end"]:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    chk = judge.checks(numbers, spec["limits"])
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": chips, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(win.done) and judge.passed(chk),
           "attempted": len(win.pulls) * b, "failed": len(win.pulls) * b - sum(sizes),
           "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        out["breakdown"] = tr.breakdown()
    out["checks"] = chk
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, rel in CACHE_DIRS.items():
        os.environ[var] = str(ROOT / rel)
    spec = load_spec(args.workload)
    chips = int(spec["cell"]["chips"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    print(card_line(torch, chips), file=sys.stderr, flush=True)
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"no result: loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, v in result["checks"].items():
        print(f"check {name}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
