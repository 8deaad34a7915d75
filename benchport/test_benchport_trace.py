"""The trace reader on a synthetic trace (CPU)."""

import pytest

from benchport import trace as T
from benchport.trace import Event


def _trace():
    ms = 1_000_000
    return [
        Event("span", "bp:window", 0, 100 * ms),
        Event("span", "bp:planner.dispatch", 5 * ms, 20 * ms),
        Event("span", "bp:segment.search", 6 * ms, 12 * ms),
        Event("span", "bp:scan_topk@segment.search", 7 * ms, 8 * ms),
        Event("span", "bp:planner.finish", 40 * ms, 90 * ms),
        # launches (runtime calls) and the operations they put on the device
        Event("runtime", "cudaLaunchKernel", int(7.5 * ms), int(7.6 * ms), corr=1),
        Event("device", "scan_short_kernel", 10 * ms, 30 * ms, corr=1),
        Event("runtime", "cudaLaunchKernel", 15 * ms, int(15.1 * ms), corr=2),
        Event("device", "merge", 30 * ms, 35 * ms, corr=2),
        # no runtime call: found through the host op that enclosed the launch
        Event("op", "aten::topk", 16 * ms, 17 * ms, corr=50),
        Event("device", "topk", 34 * ms, 38 * ms, corr=3, link=50),
        # partly outside the window
        Event("device", "late", 95 * ms, 110 * ms, corr=4),
    ]


def test_busy_time_is_the_union_inside_the_window():
    tr = T.reduce(_trace())
    assert tr.window_s == pytest.approx(0.1)
    assert tr.busy_s == pytest.approx((38 - 10 + 5) / 1e3)
    assert tr.unattributed == 1  # "late" has no launch


def test_operations_belong_to_the_spans_open_at_their_launch():
    tr = T.reduce(_trace())
    spans = {k.name: k.spans for k in tr.kernels}
    assert spans["scan_short_kernel"] == {"planner.dispatch", "segment.search",
                                          "scan_topk@segment.search"}
    assert spans["merge"] == {"planner.dispatch"}
    assert spans["topk"] == {"planner.dispatch"}
    assert tr.device_s("scan_topk@segment.search") == pytest.approx(0.020)
    assert tr.device_s("planner.dispatch") == pytest.approx(0.028)


def test_idle_gaps_go_to_the_innermost_open_span():
    tr = T.reduce(_trace())
    assert tr.idle_by_span["harness"] == pytest.approx(0.012)  # 0-5, 38-40, 90-95 ms
    assert tr.idle_by_span["planner.dispatch"] == pytest.approx(0.001)  # 5-6 ms
    assert tr.idle_by_span["segment.search"] == pytest.approx(0.003)  # 6-7, 8-10 ms
    assert tr.idle_by_span["scan_topk@segment.search"] == pytest.approx(0.001)  # 7-8 ms
    assert tr.idle_by_span["planner.finish"] == pytest.approx(0.050)  # 40-90 ms
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["scan_short_kernel", pytest.approx(0.020)]
    assert bd["idle_gaps"][0][0] == "planner.finish"
    assert len(bd["device_ops"]) <= T.TOP and len(bd["idle_gaps"]) <= T.TOP


def test_one_window_is_required():
    with pytest.raises(ValueError):
        T.reduce([e for e in _trace() if e.name != "bp:window"])


def test_union():
    assert T.union_ns([(0, 10), (5, 15), (20, 30), (25, 26)]) == 25
    assert T.union_ns([]) == 0
