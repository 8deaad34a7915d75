"""planner.finish_ms: host milliseconds a batch spends in the planner's
`engine/search._finish` (decoding merged candidates, the MVCC visibility and
dirty-id checks, compaction to k), over the window's completed batches.
Moves `qps`."""


def read(rec):
    calls = rec.host.get("planner.finish")
    if not calls or not rec.batches:
        return None
    return 1e3 * sum(calls) / rec.batches
