"""The filtered cell's readers, `scan_topk.compact_roofline` and
`scan_topk.memtable_masked_ms`, on a synthetic record (CPU)."""

import pytest

from benchport import roofline, run
from benchport import trace as T
from benchport.trace import Event

MS = 1_000_000


def _record(scans, batches=2):
    """A window of two batches: each a compact scan (4 ms on the device) and
    a memtable scan (1.5 ms), and a segment scan's span that launches none."""
    events = [Event("span", "bp:window", 0, 100 * MS)]
    corr = 1
    for t0 in (0, 50):
        for label, start, dur in (("scan_topk", 1, 4), ("scan_topk@memtable.search", 10, 1.5)):
            a = (t0 + start) * MS
            events += [Event("span", "bp:" + label, a, a + MS),
                       Event("runtime", "cudaLaunchKernel", a + 10, a + 20, corr=corr),
                       Event("device", "kernel", a + MS, a + MS + int(dur * MS), corr=corr)]
            corr += 1
    return run.Record({}, {}, batches, {}, scans, T.reduce(events), 0.0)


def _compact(masked=False):
    return dict(span="scan_topk", b=4096, n=100_000, d=1536, k=124, table="bf16", masked=masked)


def _memtable(masked=True):
    return dict(span="scan_topk@memtable.search", b=4096, n=8192, d=1536, k=100, table="f32",
                masked=masked)


def test_compact_roofline_is_the_bound_over_the_compact_scans_device_time():
    rec = _record([_compact(), _memtable(), _compact(), _memtable()])
    want = 100 * 2 * roofline.scan_bound_s(4096, 100_000, 1536, 124, "bf16") / 8e-3
    assert run.read_metric("scan_topk.compact_roofline", rec) == pytest.approx(want)
    assert 0 < want <= 100


def test_compact_roofline_reads_nothing_without_compact_scans():
    assert run.read_metric("scan_topk.compact_roofline", _record([_memtable()])) is None
    no_trace = _record([_compact()])
    no_trace.trace = None
    assert run.read_metric("scan_topk.compact_roofline", no_trace) is None


def test_memtable_masked_ms_is_a_batchs_device_time_of_masked_scans():
    rec = _record([_compact(), _memtable(), _compact(), _memtable()])
    assert run.read_metric("scan_topk.memtable_masked_ms", rec) == pytest.approx(1.5)


@pytest.mark.parametrize("scans", [[_compact()], [_memtable(masked=False)],
                                   [_memtable(), _memtable(masked=False)]],
                         ids=["no_memtable_scan", "unmasked", "mixed"])
def test_memtable_masked_ms_reads_only_a_window_of_masked_scans(scans):
    assert run.read_metric("scan_topk.memtable_masked_ms", _record(scans)) is None


def test_the_filtered_cells_entries():
    spec = run.load_spec("dbpedia1536append-filter10-knn100")
    assert spec["traffic"]["filter"] == {"field": "u", "op": "lt", "value": 10}
    assert spec["config"]["deletes"] == 0 and "options" not in spec["config"]
    assert {m["name"] for m in spec["end_to_end"]} == {"recall_at_k", "peak_device_gib",
                                                       "setup_s"}
    assert {m["name"] for m in spec["per_layer"]} == {"scan_topk.compact_roofline",
                                                      "scan_topk.memtable_masked_ms"}
    reported = {m["name"] for m in spec["end_to_end"]}
    assert all(m["moves"] in reported for m in spec["per_layer"])
