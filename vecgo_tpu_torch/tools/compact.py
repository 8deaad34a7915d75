"""Offline compaction job: `python -m vecgo_tpu_torch.tools.compact <db_dir>`.

Opens the database at <db_dir>, merges segments (all of them with --all,
else the compaction policy's pick), writes the merged segment and a new
manifest version, and exits. A serving process then reopens the database
(or, as a read replica, loads the new CURRENT) to pick the result up. The
reference's cloud topology is writer/reader separation over a shared store
with CAS-committed manifests (vecgo.go:151-179,
blobstore/s3/ddb_commit_store.go): compaction belongs to the writer.

The CLI is the JAX package's (vecgo_tpu/tools/compact.py), plus --device
("cuda" by default; "cpu" runs the plain PyTorch versions). Either package
opens the directory afterwards.

Exit code 0 = compacted (or nothing to do); prints one JSON line with the
outcome.
"""

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("db_dir", help="database directory (Local backend)")
    p.add_argument("--all", action="store_true",
                   help="merge ALL live segments (default: the policy's pick)")
    p.add_argument("--vacuum", action="store_true", help="also vacuum old versions after")
    # Build knobs are runtime options, not manifest config: the writer job
    # takes them on its command line (reference analogue: engine Options are
    # per-open, engine.go:154-352).
    p.add_argument("--graph-threshold", type=int, default=None)
    p.add_argument("--graph-r", type=int, default=None)
    p.add_argument("--graph-l-build", type=int, default=None)
    p.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    args = p.parse_args(argv)

    from vecgo_tpu_torch.blobstore import LocalStore
    from vecgo_tpu_torch.engine import Engine, EngineOptions

    opts = EngineOptions(device=args.device)
    if args.graph_threshold is not None:
        opts.graph_threshold = args.graph_threshold
    if args.graph_r is not None:
        opts.graph_r = args.graph_r
    if args.graph_l_build is not None:
        opts.graph_l_build = args.graph_l_build
    t0 = time.perf_counter()
    eng = Engine.open(LocalStore(args.db_dir), opts)
    try:
        seg_ids = [h.seg_id for h in eng._segments] if args.all else eng.pick_compaction()
        out = {"db_dir": args.db_dir, "inputs": seg_ids or []}
        if seg_ids:
            out["version"] = eng.compact(seg_ids)
            out["segment"] = type(eng._segments[-1].segment).__name__
            out["rows"] = int(eng._segments[-1].segment.n)
        else:
            out["version"] = None
        if args.vacuum:
            out["vacuum"] = eng.vacuum()
        out["elapsed_s"] = round(time.perf_counter() - t0, 1)
        print(json.dumps(out), flush=True)
        return 0
    finally:
        eng.close()


if __name__ == "__main__":
    sys.exit(main())
