"""scan_topk.memtable_masked_ms: device milliseconds a batch spends in the
memtable's masked chunk scans (`engine/memtable.MemTable.search` -> f32
`scan_topk` with a row mask: a filter, or deleted rows), over the window's
completed batches. The trace attributes device time to the span, not to
each call, so the reader reads only a window in which every memtable scan
was masked, and nothing where any was not. Moves `setup_s` in its cell,
which reports no `qps`."""


def read(rec):
    span = "scan_topk@memtable.search"
    calls = [c for c in rec.scans if c["span"] == span]
    if rec.trace is None or not rec.batches or not calls or not all(c["masked"] for c in calls):
        return None
    return 1e3 * rec.trace.device_s(span) / rec.batches
