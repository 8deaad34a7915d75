"""planner.dispatch_ms: host milliseconds a batch spends in the planner's
`engine/search._dispatch_batch` (the plan or the plan cache's, the query
upload, every source's scan enqueued, the device merge and the result copies
enqueued), over the window's completed batches. Moves `qps`."""


def read(rec):
    calls = rec.host.get("planner.dispatch")
    if not calls or not rec.batches:
        return None
    return 1e3 * sum(calls) / rec.batches
