"""Tracing and profiling helpers (counterpart of thermal3d/core/profiling.py),
on torch.profiler:

  * `trace(logdir)`: a torch.profiler run over the block (CPU, and CUDA when
    there is a card), written to `logdir` as a Chrome trace (Perfetto,
    chrome://tracing); yields the profiler, whose key_averages() sum the
    spans by name. It empties the span registry first.
  * `annotate(name, device=None, request=None)`: a span of the port's own
    layers (the engine, the generator, the model, the geometry, the
    pipeline). It records only while a torch profiler records, and never
    inside a torch.compile or torch.export trace; otherwise it is one shared
    no-op. A recorded span is a CPU op on the profiler's clock
    (RecordFunctionFast: not a user annotation, so it puts nothing on the
    device timeline) and a `Span` in an in-memory registry: name, parent
    (this thread's innermost open span), request id, host start and end
    (perf_counter_ns), and with a CUDA `device` a pair of timing events on
    that device's current stream, resolved to device ms only when read.
    `request=NEW_REQUEST` opens a request (an entry point); LAST_REQUEST
    takes the id of the last request this thread opened; an int is that id;
    None inherits the parent's. `current()` and `within(span)` hand a span
    to another thread (a thread's stack of open spans is its own).
    `spans()`, `request_ids()` and `totals()` read the registry; `clear()`
    empties it.
  * `StageTimer`: wall-clock time by named stage; `stage(name, *tensors)`
    synchronises the CUDA devices of the tensors it is given before it
    stops the clock, so device work counts to its stage.
  * `nan_guard()`: raises FloatingPointError at the first op whose floating
    output holds a NaN (the JAX `jax_debug_nans` mode; torch's anomaly mode
    checks only the backward).
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional, Set, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block and write `logdir/trace_<pid>_<ns>.json`."""
    os.makedirs(logdir, exist_ok=True)
    clear()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


NEW_REQUEST = object()  # annotate(request=...): this span opens a request
LAST_REQUEST = object()  # ... carries the last request this thread opened

_OFF = contextlib.nullcontext()  # what annotate and within return when off
_registry: List["Span"] = []
_request_ids = itertools.count()
_local = threading.local()  # .stack: open spans; .last_request: an id
_handed = 0  # threads inside within(): they record without a profiler
_handed_lock = threading.Lock()


@dataclasses.dataclass(eq=False)
class Span:
    name: str
    parent: Optional["Span"]
    request: Optional[int]
    start_ns: int
    end_ns: int = 0
    events: Optional[Tuple[torch.cuda.Event, torch.cuda.Event]] = None

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    def device_ms(self) -> Optional[float]:
        """Device ms between the span's events (waits for the second), or
        None for a span without them."""
        if self.events is None:
            return None
        start, end = self.events
        end.synchronize()
        return start.elapsed_time(end)


def _stack() -> List[Span]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Recording:
    __slots__ = ("name", "device", "request", "op", "span", "stream")

    def __init__(self, name: str, device, request):
        self.name, self.device, self.request = name, device, request

    def __enter__(self) -> Span:
        stack = _stack()
        parent = stack[-1] if stack else None
        request = self.request
        if request is NEW_REQUEST:
            request = _local.last_request = next(_request_ids)
        elif request is LAST_REQUEST:
            request = getattr(_local, "last_request", None)
        elif request is None and parent is not None:
            request = parent.request
        self.op = torch._C._profiler._RecordFunctionFast(self.name)
        self.op.__enter__()
        span = self.span = Span(self.name, parent, request, time.perf_counter_ns())
        self.stream = None
        if self.device is not None and torch.device(self.device).type == "cuda":
            self.stream = torch.cuda.current_stream(self.device)
            span.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            span.events[0].record(self.stream)
        stack.append(span)
        _registry.append(span)
        return span

    def __exit__(self, *exc) -> bool:
        _stack().pop()
        if self.stream is not None:
            self.span.events[1].record(self.stream)
        self.span.end_ns = time.perf_counter_ns()
        self.op.__exit__(*exc)
        return False


def annotate(name: str, device=None, request=None):
    """`with annotate(name[, device][, request]) as span:` a span of the
    port's layers (module docstring); `span` is the recorded Span, or None
    when spans are off. A thread records while a torch profiler records on
    it (the profiler is thread-local) or while it holds a span handed to it
    by within(); never inside a compile or export trace."""
    if (torch.autograd._profiler_enabled() or _handed) and _recording_here():
        return _Recording(name, device, request)
    return _OFF


def _recording_here() -> bool:
    return not torch.compiler.is_compiling() and (
        torch.autograd._profiler_enabled() or bool(getattr(_local, "stack", None)))


def current() -> Optional[Span]:
    """This thread's innermost open span, or None."""
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


class _Within:
    __slots__ = ("span",)

    def __init__(self, span: Span):
        self.span = span

    def __enter__(self) -> Span:
        global _handed
        with _handed_lock:
            _handed += 1
        _stack().append(self.span)
        return self.span

    def __exit__(self, *exc) -> bool:
        global _handed
        _stack().pop()
        with _handed_lock:
            _handed -= 1
        return False


def within(span: Optional[Span]):
    """Spans this thread opens in the block are recorded, with `span`
    (another thread's, from current()) as their parent and its request id."""
    return _OFF if span is None else _Within(span)


def spans() -> List[Span]:
    """The recorded spans, in the order they opened."""
    return list(_registry)


def request_ids() -> Set[int]:
    """The distinct request ids of the recorded spans."""
    return {s.request for s in _registry if s.request is not None}


def clear() -> None:
    _registry.clear()


def _covered_ns(intervals, lo: int, hi: int) -> int:
    """ns of [lo, hi] that the union of `intervals` covers."""
    total, end = 0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def totals() -> Dict[str, Dict[str, float]]:
    """Per span name, over every recorded span: host_ms; self_ms (host ms
    less what the span's children cover of it); device_ms (None where no
    span of the name has device events); count; requests (distinct request
    ids)."""
    recorded = list(_registry)
    children: Dict[int, List[Tuple[int, int]]] = defaultdict(list)
    for s in recorded:
        if s.parent is not None:
            children[id(s.parent)].append((s.start_ns, s.end_ns))
    out: Dict[str, Dict[str, float]] = {}
    ids: Dict[str, Set[int]] = defaultdict(set)
    for s in recorded:
        t = out.setdefault(s.name, {"host_ms": 0.0, "self_ms": 0.0, "device_ms": None,
                                    "count": 0})
        covered = _covered_ns(children.get(id(s), ()), s.start_ns, s.end_ns)
        t["host_ms"] += s.host_ms
        t["self_ms"] += s.host_ms - covered / 1e6
        t["count"] += 1
        device = s.device_ms()
        if device is not None:
            t["device_ms"] = (t["device_ms"] or 0.0) + device
        if s.request is not None:
            ids[s.name].add(s.request)
    for name, t in out.items():
        t["requests"] = len(ids[name])
    return out


class _NanGuard(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.is_floating_point() and torch.isnan(t).any():
                raise FloatingPointError(f"NaN in the output of {func}")
        return out


@contextlib.contextmanager
def nan_guard():
    """Raise FloatingPointError at the first op of the block that makes a
    NaN. Each check reads the output back to the host: a debugging mode."""
    with _NanGuard():
        yield


class StageTimer:
    """Accumulates wall-clock time by named stage."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, *sync_tensors: torch.Tensor):
        t0 = time.perf_counter()
        yield
        for device in {t.device for t in sync_tensors if t.is_cuda}:
            torch.cuda.synchronize(device)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "count": self.counts[name],
                "mean_ms": round(1000 * self.totals[name] / max(self.counts[name], 1), 3),
            }
            for name in self.totals
        }

    def report(self) -> str:
        return json.dumps(self.summary(), indent=2)
