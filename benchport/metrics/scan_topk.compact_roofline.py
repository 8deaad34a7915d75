"""scan_topk.compact_roofline: the planner's compact-gather scans as a share
of their roofline, in percent. These are the `scan_topk` calls launched
outside every `.search` span (`engine/search._compact_search` scans the
filter's gathered sub-corpus, a dense bf16 or f32 table with no mask), which
`drive.Probe` labels plain `scan_topk`. The bound is `roofline.scan_bound_s`
summed over those calls; the time is the device time of the operations they
launched (profiler intervals). Moves `setup_s` in its cell, which reports no
`qps`."""

from benchport import roofline


def read(rec):
    span = "scan_topk"
    calls = [c for c in rec.scans if c["span"] == span]
    if not calls or rec.trace is None:
        return None
    bound = sum(roofline.scan_bound_s(c["b"], c["n"], c["d"], c["k"], c["table"], c["masked"])
                for c in calls)
    return roofline.share_pct(bound, rec.trace.device_s(span))
