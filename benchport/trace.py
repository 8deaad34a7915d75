"""Reads a traced window: device busy time, kernels by the host span that
launched them, and idle gaps by what the host was doing.

`from_profiler` turns a `torch.profiler` trace into plain `Event`s;
`reduce` works on those alone, so that the arithmetic is testable without
a card. Host spans are the benchmark's own `record_function` ranges, named
`bp:<span>` (`drive.Probe`); the window is the range `bp:window`. A device
operation (kernel, copy or memset) is attributed to every span that was open
on the host when its launch started: the runtime call with the same
correlation id, or else the host event the profiler links it to.
"""

from __future__ import annotations

import heapq
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional

WINDOW = "bp:window"
SPAN_PREFIX = "bp:"
_RUNTIME_PREFIXES = ("cuda", "cu")  # cudaLaunchKernel, cuLaunchKernel, cudaMemcpyAsync, ...
TOP = 10  # entries of each breakdown list


@dataclass
class Event:
    kind: str  # "device", "runtime", "op" or "span"
    name: str
    start_ns: int
    end_ns: int
    corr: int = 0
    link: int = 0


@dataclass
class Kernel:
    name: str
    start_ns: int
    end_ns: int
    spans: frozenset  # host spans open at its launch


@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: List[Kernel]
    idle_by_span: Dict[str, float] = field(default_factory=dict)  # seconds
    unattributed: int = 0  # device operations whose launch was not found

    def device_s(self, span: str) -> float:
        """Device seconds (the union of intervals) of the operations launched
        inside `span`."""
        return union_ns([(k.start_ns, k.end_ns) for k in self.kernels if span in k.spans]) / 1e9

    def breakdown(self) -> dict:
        """The device operations that took most time, and the idle time by
        what the host was doing, each a list of [name, seconds]."""
        ops: Dict[str, float] = defaultdict(float)
        for k in self.kernels:
            ops[k.name] += (k.end_ns - k.start_ns) / 1e9
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]
        idle = sorted(self.idle_by_span.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n, s] for n, s in top], "idle_gaps": [[n, s] for n, s in idle]}


def union_ns(intervals) -> int:
    """Length of the union of [start, end) intervals."""
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _classify(ev) -> Optional[str]:
    """"span" (a benchmark range on the host), "device" (a kernel, copy or
    memset), "runtime" (a `cuda*` or `cu*` API call on the host), "op" (any
    other host event: an aten op), or None."""
    name = ev.name()
    on_device = str(ev.device_type()).endswith("CUDA")
    if ev.is_user_annotation():
        return "span" if not on_device and name.startswith(SPAN_PREFIX) else None
    if on_device:
        return None if name.startswith(SPAN_PREFIX) else "device"
    if name.startswith(_RUNTIME_PREFIXES):
        return "runtime"
    return "op"


def from_profiler(prof) -> List[Event]:
    """The trace's spans, host calls and device operations. A device
    operation's `corr` is its runtime call's correlation id; `link` is the id
    of the host event that enclosed the launch."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        kind = _classify(ev)
        if kind is not None:
            out.append(Event(kind, ev.name(), int(ev.start_ns()), int(ev.end_ns()),
                             int(ev.correlation_id()), int(ev.linked_correlation_id())))
    return out


def kinds(events: List[Event]) -> Dict[str, int]:
    """How many events of each kind a trace holds."""
    out: Dict[str, int] = defaultdict(int)
    for e in events:
        out[e.kind] += 1
    return dict(out)


def reduce(events: List[Event]) -> Trace:
    """Busy time, attributed kernels and idle gaps inside the window span."""
    windows = [e for e in events if e.kind == "span" and e.name == WINDOW]
    if len(windows) != 1:
        raise ValueError(f"expected one {WINDOW} span, found {len(windows)}")
    w0, w1 = windows[0].start_ns, windows[0].end_ns
    spans = sorted((e.start_ns, e.end_ns, e.name[len(SPAN_PREFIX):]) for e in events
                   if e.kind == "span" and e.name != WINDOW)
    launch = {e.corr: e.start_ns for e in events if e.kind == "runtime"}
    host = {e.corr: e.start_ns for e in events if e.kind in ("op", "span")}
    device = sorted((max(e.start_ns, w0), min(e.end_ns, w1), e.name,
                     launch.get(e.corr, host.get(e.link) if e.link else None))
                    for e in events if e.kind == "device" and e.end_ns > w0 and e.start_ns < w1)

    # Spans open at each launch: a sweep over launches in time order.
    order = sorted(range(len(device)), key=lambda i: device[i][3] if device[i][3] is not None
                   else -1)
    tags: List[frozenset] = [frozenset()] * len(device)
    open_spans: list = []  # heap of (end, name)
    nxt = 0
    unattributed = 0
    for i in order:
        t = device[i][3]
        if t is None:
            unattributed += 1
            continue
        while nxt < len(spans) and spans[nxt][0] <= t:
            heapq.heappush(open_spans, (spans[nxt][1], spans[nxt][2]))
            nxt += 1
        while open_spans and open_spans[0][0] < t:
            heapq.heappop(open_spans)
        tags[i] = frozenset(name for _, name in open_spans)
    kernels = [Kernel(name, a, b, tags[i]) for i, (a, b, name, _) in enumerate(device)]

    busy = union_ns([(k.start_ns, k.end_ns) for k in kernels])
    return Trace((w1 - w0) / 1e9, busy / 1e9, kernels,
                 _idle_by_span(kernels, spans, w0, w1), unattributed)


def _host_pieces(spans: list, w0: int, w1: int) -> list:
    """[w0, w1) cut into pieces (start, end, innermost open span or
    "harness", the benchmark's own loop between calls into the program)."""
    cuts = sorted({w0, w1} | {t for a, b, _ in spans for t in (a, b) if w0 < t < w1})
    pieces, open_spans, nxt = [], [], 0  # heap of (end, -start, name)
    for a, b in zip(cuts, cuts[1:]):
        mid = (a + b) / 2
        while nxt < len(spans) and spans[nxt][0] <= mid:
            heapq.heappush(open_spans, (spans[nxt][1], -spans[nxt][0], spans[nxt][2]))
            nxt += 1
        while open_spans and open_spans[0][0] <= mid:
            heapq.heappop(open_spans)
        name = max(open_spans, key=lambda sp: -sp[1])[2] if open_spans else "harness"
        pieces.append((a, b, name))
    return pieces


def _idle_by_span(kernels: List[Kernel], spans: list, w0: int, w1: int) -> Dict[str, float]:
    """The device's idle time in [w0, w1), charged to the innermost host span
    open at each moment of it."""
    gaps, end = [], w0
    for k in sorted(kernels, key=lambda k: k.start_ns):
        if k.start_ns > end:
            gaps.append((end, k.start_ns))
        end = max(end, k.end_ns)
    if end < w1:
        gaps.append((end, w1))
    out: Dict[str, float] = defaultdict(float)
    pieces = _host_pieces(spans, w0, w1)
    i = 0
    for g0, g1 in gaps:  # both in time order
        while i < len(pieces) and pieces[i][1] <= g0:
            i += 1
        j = i
        while j < len(pieces) and pieces[j][0] < g1:
            a, b, name = pieces[j]
            out[name] += (min(b, g1) - max(a, g0)) / 1e9
            j += 1
    return dict(out)
