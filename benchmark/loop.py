"""The closed loop a cell's clients run, and the record of its window.

`clients` requests are in flight: the loop waits for the oldest, and that
client sends its next request at once, so the program dispatches a request
while the one before it still computes. Everything runs on the calling
thread, as the program's own pipelined entry points do.

Phases, in one unbroken loop: `warmup` completed requests (set-up), then the
measured window of `seconds` (requests sent in it, and the work completed in
it), then the drain of what is still in flight. A traced run adds, after the
drain, a slice of exactly `trace_requests` requests from an empty pipeline
under the profiler, so that per-request device numbers divide exactly.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Iterator, List, Optional

import numpy as np


@dataclasses.dataclass
class Request:
    index: int  # the pool entry it sends
    sent: float  # host clock when it was handed to the program
    issued: float  # host clock when its dispatch calls returned
    done: float = 0.0  # host clock when its outputs were in numpy
    in_window: bool = False  # sent inside the measured window


@dataclasses.dataclass
class Window:
    start: float  # the completion that ended the warm-up
    end: float  # start + seconds: no request is sent after it
    requests: List[Request]  # sent in the window, in completion order
    completed_units: int  # units of the requests completed in (start, end]
    completed: int
    last_done: float  # the last of those completions

    @property
    def rate(self) -> float:
        """Units completed a second, from the completion that opened the
        window to the last one in it: whole intervals between completions,
        so a rate is not rounded to whole requests a window."""
        return self.completed_units / (self.last_done - self.start) if self.completed else 0.0


class Sampler:
    """A seeded reservoir of `k` requests of the window, with copies of their
    outputs (the program's client reuses its output arrays)."""

    def __init__(self, k: int, seed: int):
        self.k, self.seen, self.items = k, 0, []
        self.rng = np.random.default_rng(seed)

    def offer(self, index: int, outputs) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append((index, {k: v.copy() for k, v in outputs.items()}))
        else:
            j = int(self.rng.integers(self.seen))
            if j < self.k:
                self.items[j] = (index, {k: v.copy() for k, v in outputs.items()})


def run_window(program, requests: Iterator, clients: int, warmup: int, seconds: float,
               units: int, sampler: Sampler, sync: Callable[[], None]) -> Window:
    """Warm up, measure for `seconds`, drain. `requests` yields (index,
    input) pairs; outputs of window requests are offered to `sampler`."""
    inflight: collections.deque = collections.deque()
    start = end = last_done = None
    window: List[Request] = []
    completed_units = completed = 0

    def send():
        index, item = next(requests)
        t0 = time.perf_counter()
        token = program.submit(item)
        req = Request(index, t0, time.perf_counter())
        req.in_window = start is not None and t0 < end
        inflight.append((req, token))

    for _ in range(clients):
        send()
    n_done = 0
    while inflight:
        req, token = inflight.popleft()
        outputs = program.finish(token)
        req.done = now = time.perf_counter()
        n_done += 1
        if req.in_window:
            window.append(req)
            sampler.offer(req.index, outputs)
        if start is not None and now <= end:
            completed_units += units
            completed += 1
            last_done = now
        if start is None and n_done == warmup:
            start = now
            end = start + seconds
        if start is None or time.perf_counter() < end:
            send()
    sync()
    return Window(start, end, window, completed_units, completed, last_done)


@dataclasses.dataclass
class Slice:
    """A traced slice: its host-clock length and the requests it ran."""

    seconds: float
    requests: int


def run_slice(program, requests: Iterator, clients: int, n: int,
              sync: Callable[[], None]) -> Slice:
    """Exactly n requests from an empty pipeline, `clients` in flight."""
    inflight: collections.deque = collections.deque()
    sync()
    t0 = time.perf_counter()
    sent = 0
    while sent < min(clients, n):
        inflight.append(program.submit(next(requests)[1]))
        sent += 1
    while inflight:
        program.finish(inflight.popleft())
        if sent < n:
            inflight.append(program.submit(next(requests)[1]))
            sent += 1
    sync()
    return Slice(time.perf_counter() - t0, n)


def percentile(values, q: float) -> Optional[float]:
    return float(np.percentile(np.asarray(values, np.float64), q)) if len(values) else None
