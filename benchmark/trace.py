"""The traced slice: torch.profiler over a fixed number of requests, reduced
to device spans, the device's busy time (the union of its spans), and the
breakdown the result line carries.

The reduction follows the port's smoke script's profile (device spans summed
by kernel name, busy time as their union), frozen here so that a later
change to the program cannot move it. An idle gap is put down to the
innermost host op of the main thread running at its middle ("no_host_op":
the host was in Python or numpy, between ops).
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Callable, Dict, List, Tuple

Span = Tuple[float, float, str]  # start µs, end µs, kernel or copy name


def busy_intervals(spans) -> List[Tuple[float, float]]:
    """The disjoint intervals (start µs, end µs) that spans cover together."""
    merged: List[List[float]] = []
    for start, end, *_ in sorted(spans):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


@dataclasses.dataclass
class Trace:
    spans: List[Span]
    busy_s: float
    window_s: float
    requests: int
    counters: Dict[str, float]  # the program's launch counters, a request
    breakdown: dict

    def kernel_ms(self, match: Callable[[str], bool]) -> float:
        """Device ms of the spans whose lower-cased name `match`es."""
        return sum(e - s for s, e, n in self.spans if match(n.lower())) / 1e3

    def kernel_count(self, match: Callable[[str], bool]) -> int:
        return sum(1 for *_, n in self.spans if match(n.lower()))


def name_matcher(include, exclude=()) -> Callable[[str], bool]:
    def match(low: str) -> bool:
        return any(k in low for k in include) and not any(k in low for k in exclude)
    return match


def _host_op_at(points: List[float], events) -> List[str]:
    """For each sorted point, the innermost host op of `events` (start, end,
    name; properly nested, one thread) running at it."""
    events = sorted(events, key=lambda e: (e[0], -e[1]))
    out, stack, i = [], [], 0
    for t in points:
        while i < len(events) and events[i][0] <= t:
            while stack and stack[-1][1] <= events[i][0]:
                stack.pop()
            stack.append(events[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else "no_host_op")
    return out


def reduce_profile(prof, window_s: float, requests: int, counters, top: int = 10) -> Trace:
    from torch.autograd import DeviceType

    events = prof.events()
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in events
             if e.device_type == DeviceType.CUDA]
    host = [e for e in events if e.device_type == DeviceType.CPU]
    main = Counter(e.thread for e in host).most_common(1)
    host_ops = [(e.time_range.start, e.time_range.end, e.name) for e in host
                if main and e.thread == main[0][0]]
    by_name: Dict[str, float] = {}
    for s, e, n in spans:
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e6
    busy = busy_intervals(spans)
    gaps = [(b0[1], b1[0]) for b0, b1 in zip(busy, busy[1:]) if b1[0] > b0[1]]
    mids = [(a + b) / 2 for a, b in gaps]
    order = sorted(range(len(gaps)), key=mids.__getitem__)
    names = _host_op_at([mids[i] for i in order], host_ops)
    by_op: Dict[str, float] = {}
    for i, name in zip(order, names):
        by_op[name] = by_op.get(name, 0.0) + (gaps[i][1] - gaps[i][0]) / 1e6
    breakdown = {
        "device_ops": [[n[:120], s] for n, s in sorted(by_name.items(), key=lambda kv: -kv[1])
                       ][:top],
        "idle_gaps": [[n[:120], s] for n, s in sorted(by_op.items(), key=lambda kv: -kv[1])][:top],
    }
    busy_s = sum(b - a for a, b in busy) / 1e6
    return Trace(spans, busy_s, window_s, requests, counters, breakdown)

