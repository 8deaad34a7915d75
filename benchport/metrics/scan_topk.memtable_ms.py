"""scan_topk.memtable_ms: device milliseconds a batch spends in the
memtable's chunk scans (`engine/memtable.MemTable.search` -> f32
`scan_topk`; profiler intervals), over the window's completed batches.
Moves `qps`."""


def read(rec):
    span = "scan_topk@memtable.search"
    if rec.trace is None or not rec.batches or not any(c["span"] == span for c in rec.scans):
        return None
    return 1e3 * rec.trace.device_s(span) / rec.batches
