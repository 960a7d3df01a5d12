"""Spans of the port's layers and helpers that time kernels on the card.

The port's counterpart of the JAX package's ``utils/profiling.py``:

  * ``span(name)``, ``spans()``  named spans of the port's layers,
                           recorded only while a ``torch.profiler`` session
                           is open, kept in memory (the newest
                           ``SPAN_BUFFER``);
  * ``profile_device_time(...)``  the device durations of the CUDA kernels
                           whose name contains a substring, read from
                           ``torch.profiler``'s events;
  * ``device_ms_in_turns(...)``  two functions' mean kernel durations
                           from ``torch.profiler``, timed in turns;
  * ``device_ms_per_call(...)``  one function's device time per call
                           under ``torch.profiler``, by kernel name;
  * ``cuda_ms(...)``       a function's mean device time from CUDA events.

The port's benchmark, its work counts and the card's peaks are in
``gsbench/`` (``gsbench/counts.py``), which reads the spans; the port does
not import it. So the JAX package's ``benchmark`` and roofline (MXU
passes, VPU ratio, ``TPU_PEAKS``) have no counterpart here, nor its
``trace`` (``torch.profiler`` exports a Chrome trace).

Spans: ``with span("render"): ...`` marks a layer of the port. Outside a
profiler session it costs one attribute read and returns a shared object
that records nothing. Inside one it records the span's name, its parent
(the innermost span open on the same thread), its thread, its start and end
on ``time.perf_counter_ns()`` and its unit: a ``step`` or ``view`` span
opens a unit of work, and every span inside it carries that unit's id.
Where CUDA is initialised it also records two timing events on the current
stream, at enter and at exit, each bracketed by host times (``marks``):
each record shows in the profiler's trace as a runtime call
(``cudaEventRecordWithFlags`` under torch 2.11), so the marks put the spans
on the trace's clock. Events come from a pool and return to it when their
span leaves the buffer.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------

# spans that open a unit of work; the spans inside one share its id
UNIT_SPANS = ("step", "view")
# the newest spans kept in memory
SPAN_BUFFER = 10_000


class SpanRecord(NamedTuple):
    """One closed span. ``start_ns`` / ``end_ns`` and each ``marks`` pair
    (host times just before and after a CUDA event record, enter's
    first) are ``time.perf_counter_ns()``. ``device_ms`` is the card's
    time between the span's two events; None without events or before
    the card has passed the second."""

    id: int
    name: str
    parent: Optional[int]
    thread: int
    unit: Optional[int]
    start_ns: int
    end_ns: int
    marks: tuple
    device_ms: Optional[float]


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()
_SPANS: collections.deque = collections.deque()
_EVENT_POOL: list = []
_LOCK = threading.Lock()
_LOCAL = threading.local()
_IDS = itertools.count()


def _open_stack() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


class _Span:
    __slots__ = ("name", "id", "parent", "thread", "unit", "start_ns",
                 "end_ns", "marks", "events")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _open_stack()
        outer = stack[-1] if stack else None
        self.id = next(_IDS)
        self.parent = None if outer is None else outer.id
        self.unit = (self.id if self.name in UNIT_SPANS
                     else None if outer is None else outer.unit)
        self.thread = threading.get_ident()
        self.events = _take_events() if torch.cuda.is_initialized() else None
        self.marks = []
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        if self.events:
            self._record(self.events[0])
        return self

    def __exit__(self, *exc):
        if self.events:
            self._record(self.events[1])
        self.end_ns = time.perf_counter_ns()
        _open_stack().pop()
        with _LOCK:
            if len(_SPANS) >= SPAN_BUFFER:
                old = _SPANS.popleft()
                if old.events:
                    _EVENT_POOL.extend(old.events)
            _SPANS.append(self)
        return False

    def _record(self, event) -> None:
        t0 = time.perf_counter_ns()
        event.record()
        self.marks.append((t0, time.perf_counter_ns()))


def _take_events() -> list:
    with _LOCK:
        return [_EVENT_POOL.pop() if _EVENT_POOL
                else torch.cuda.Event(enable_timing=True) for _ in range(2)]


def span(name: str):
    """A context manager that records a span named ``name`` while a
    ``torch.profiler`` session is open, and nothing otherwise."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Span(name)


def _device_ms(events) -> Optional[float]:
    if not events or not events[1].query():
        return None
    return events[0].elapsed_time(events[1])


def spans() -> List[SpanRecord]:
    """The spans in the buffer, in the order they closed, each with its
    device ms. Read it after synchronising the card: it waits for
    nothing."""
    with _LOCK:
        kept = list(_SPANS)
    return [SpanRecord(s.id, s.name, s.parent, s.thread, s.unit, s.start_ns,
                       s.end_ns, tuple(s.marks), _device_ms(s.events))
            for s in kept]


# ---------------------------------------------------------------------------
# Timing helpers
# ---------------------------------------------------------------------------

def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _kernel_events(prof):
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def profile_device_time(fn, *args, iters: int = 5, warmup: int = 1,
                        name_substr: Optional[str] = None) -> list:
    """Run ``fn(*args)`` ``iters`` times under ``torch.profiler`` and
    return the device duration (s) of each CUDA kernel execution whose name
    contains ``name_substr`` (default: ``fn.__name__``), in trace order."""
    if name_substr is None:
        name_substr = getattr(fn, "__name__", "")
    for _ in range(warmup):
        fn(*args)
    _sync()
    with torch.profiler.profile(activities=_activities()) as prof:
        for _ in range(iters):
            fn(*args)
        _sync()
    return [e.device_time_total / 1e6 for e in _kernel_events(prof)
            if name_substr in e.name]


def device_ms_in_turns(a, b, per_turn: int = 15, min_launches: int = 0,
                       max_rounds: int = 4):
    """``a`` and ``b`` timed in turns (a, b, b, a; ``per_turn`` calls
    each), each turn under its own torch.profiler session, so that a
    comparison is made on one card at one time. The profiler can drop a
    session's kernel records, so the round of four turns is repeated, at
    most ``max_rounds`` times, until each function has ``min_launches``
    timed launches. Returns, for each, the mean device duration (ms) of
    the CUDA kernels its calls launched and how many the profiler timed,
    then the rounds it took."""
    a()
    b()
    _sync()
    durs = ([], [])
    rounds = 0
    while rounds < max(1, max_rounds) and (
            rounds == 0 or min(len(d) for d in durs) < min_launches):
        rounds += 1
        for i in (0, 1, 1, 0):
            with torch.profiler.profile(activities=_activities()) as prof:
                for _ in range(per_turn):
                    (a, b)[i]()
                _sync()
            durs[i].extend(e.device_time_total / 1e3
                           for e in _kernel_events(prof))
    return (*((sum(d) / len(d) if d else float("nan"), len(d))
              for d in durs), rounds)


def device_ms_per_call(fn, calls: int = 24, warmup: int = 1,
                       timed=None) -> dict:
    """``fn`` called ``calls`` times under torch.profiler. Returns, for
    each kernel (or copy) name its calls launched, (device ms per call,
    launches timed): the name's mean duration times its launches per
    call, so that a launch the profiler misses does not count as no
    time. The profiler can drop a session's kernel records: where
    ``timed(result)`` says too few were timed, the session is run again,
    at most three times in all, and the last is returned."""
    for _ in range(warmup):
        fn()
    _sync()
    for _ in range(3):
        with torch.profiler.profile(activities=_activities()) as prof:
            for _ in range(calls):
                fn()
            _sync()
        durs = {}
        for e in _kernel_events(prof):
            durs.setdefault(e.name, []).append(e.device_time_total / 1e3)
        out = {name: (sum(d) / len(d) * max(1, round(len(d) / calls)),
                      len(d)) for name, d in durs.items()}
        if timed is None or timed(out):
            break
    return out


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time (ms) of ``fn`` over ``iters`` back-to-back calls,
    from two CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters
