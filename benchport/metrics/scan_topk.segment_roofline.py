"""scan_topk.segment_roofline: the flat segment's `scan_topk` calls as a
share of their roofline, in percent. The bound is what the calls' inputs
need (`roofline.scan_bound_s`: the bf16 table read once, the f32 queries,
the row mask, the pools written once, or 2·B·N·d operations at the bf16
tensor-core peak, whichever is larger), summed over the calls; the time is
the device time of the operations those calls launched (profiler
intervals). Moves `qps`."""

from benchport import roofline


def read(rec):
    span = "scan_topk@segment.search"
    calls = [c for c in rec.scans if c["span"] == span]
    if not calls or rec.trace is None:
        return None
    device_s = rec.trace.device_s(span)
    bound = sum(roofline.scan_bound_s(c["b"], c["n"], c["d"], c["k"], c["table"], c["masked"])
                for c in calls)
    return roofline.share_pct(bound, device_s)
