"""The port's own spans on the trace's clock, and what the span metrics
read from them.

The port records a span at each of its layers (``step``, ``render``,
``project``, ``bin``, ``rasterize``, ``backward``, ``optimizer`` in a
training step; ``view`` and the same three in a view) while a profiler
session is open, so the traced window records them and the untraced
windows do not. On the card each span records a CUDA event at enter and
at exit, each between two host times (its mark); each record shows in
the trace as a runtime call (``MARKS``: ``cudaEventRecordWithFlags``
under torch 2.11; profilers that keep plain ``cudaEventRecord`` calls
give that name). The program's clock is put on the trace's by the median
over the marks of (the call's midpoint - the mark's midpoint); a mark's
residual is how far its call's midpoint then lies outside the mark.
``traced_window`` may trace up to three times and the spans of every
attempt stay in the port's buffer: the calls of the kept trace are
matched, in order, with the newest marks, and only spans inside the
window are kept.

Each moment the card is idle belongs to the innermost span open on the
host at that moment and counts in the nearest enclosing stage: an idle
gap is cut at the span edges it crosses (its midpoint alone, as
``tracing`` labels gaps, would put a gap that crosses a unit's edge
wholly on one side). A sync is a blocking runtime call (``SYNC_CALLS``)
that starts inside a unit's span, counted in the stage it starts in.
Every reader gives None where the program records no spans (it predates
them), where the trace holds no marks (no card) or where a residual is
over ``MAX_RESIDUAL_US``.
"""

from __future__ import annotations

import bisect
import dataclasses
import statistics
from typing import Dict, List, Optional, Sequence

from gsbench import tracing

MARKS = ("cudaEventRecord", "cudaEventRecordWithFlags")
MAX_RESIDUAL_US = 50.0
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")
TRAIN_STAGES = ("render", "backward", "optimizer")
VIEW_STAGES = ("project", "bin", "rasterize")


@dataclasses.dataclass(frozen=True)
class Span:
    id: int
    name: str
    parent: Optional[int]
    unit: Optional[int]
    start: float                   # us, the trace's clock
    end: float
    device_ms: Optional[float]


@dataclasses.dataclass
class Aligned:
    """The spans inside a trace's window, on its clock."""
    spans: List[Span]
    offset_us: float
    residual_us: float             # the largest mark's

    def __post_init__(self):
        self.spans = sorted(self.spans, key=lambda s: (s.start, -s.end))
        self._starts = [s.start for s in self.spans]
        self._by_id = {s.id: s for s in self.spans}
        # the stretches between consecutive span edges, each with the
        # innermost span open through it
        edges = sorted({t for s in self.spans for t in (s.start, s.end)})
        self.pieces = [(lo, hi, self.innermost(0.5 * (lo + hi)))
                       for lo, hi in zip(edges, edges[1:])]
        self._piece_starts = [p[0] for p in self.pieces]

    def units(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name and s.unit == s.id]

    def innermost(self, t: float) -> Optional[Span]:
        """The innermost span holding time ``t``: spans nest, so it is the
        last-started one that has not ended."""
        for s in reversed(self.spans[:bisect.bisect_right(self._starts, t)]):
            if s.end >= t:
                return s
        return None

    def overlaps(self, lo: float, hi: float):
        """(us, innermost span) of each stretch of ``lo``-``hi`` between
        span edges that some span holds."""
        i = max(0, bisect.bisect_right(self._piece_starts, lo) - 1)
        while i < len(self.pieces) and self.pieces[i][0] < hi:
            p_lo, p_hi, s = self.pieces[i]
            cut = min(hi, p_hi) - max(lo, p_lo)
            if cut > 0 and s is not None:
                yield cut, s
            i += 1

    def stage_of(self, s: Optional[Span], unit: str,
                 stages: Sequence[str]) -> Optional[str]:
        """The nearest of ``stages`` enclosing span ``s``, or ``unit``
        where none does; None outside every span named ``unit``."""
        top = None if s is None else self._by_id.get(s.unit)
        if top is None or top.name != unit:
            return None
        while s.name not in stages and s is not top:
            s = self._by_id[s.parent]
        return s.name


def align(records, trace) -> Optional[Aligned]:
    """``records`` (the port's ``SpanRecord``s) on ``trace``'s clock; None
    without marks or with a residual over ``MAX_RESIDUAL_US``."""
    calls = [(s, e) for name, s, e in trace.host if name in MARKS]
    marks = sorted(m for r in records for m in r.marks)
    if not calls or len(marks) < len(calls):
        return None
    marks = marks[len(marks) - len(calls):]
    diffs = [0.5 * (s + e) - 0.5e-3 * (a + b)
             for (s, e), (a, b) in zip(calls, marks)]
    offset = statistics.median(diffs)
    residual = max(max(0.0, abs(d - offset) - 0.5e-3 * (b - a))
                   for d, (a, b) in zip(diffs, marks))
    if residual > MAX_RESIDUAL_US:
        return None
    lo, hi = trace.span
    kept = [Span(r.id, r.name, r.parent, r.unit, r.start_ns * 1e-3 + offset,
                 r.end_ns * 1e-3 + offset, r.device_ms) for r in records]
    return Aligned([s for s in kept if lo <= s.start and s.end <= hi],
                   offset, residual)


def _program_spans():
    """The port's recorded spans; None where it records none."""
    try:
        from intro_to_gaussian_splatting_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    return None if read is None else read()


def aligned(trace) -> Optional[Aligned]:
    """The port's spans on ``trace``'s clock."""
    records = _program_spans()
    return None if not records or trace is None else align(records, trace)


def idle_ms(trace, unit: str,
            stages: Sequence[str]) -> Optional[Dict[str, float]]:
    """Idle ms per ``unit`` span in each of ``stages`` and, under
    ``unit``, in the rest of the unit span."""
    a = aligned(trace)
    if a is None or not a.units(unit):
        return None
    out = dict.fromkeys(tuple(stages) + (unit,), 0.0)
    for lo, hi in tracing.gaps(trace.intervals, trace.span):
        for us, s in a.overlaps(lo, hi):
            stage = a.stage_of(s, unit, stages)
            if stage is not None:
                out[stage] += us * 1e-3
    n = len(a.units(unit))
    return {k: v / n for k, v in out.items()}


def syncs(trace, unit: str,
          stages: Sequence[str] = ()) -> Optional[Dict[str, float]]:
    """Blocking runtime calls per ``unit`` span, by the stage they start
    in (``unit``: the rest of the unit span)."""
    a = aligned(trace)
    if a is None or not a.units(unit):
        return None
    out = dict.fromkeys(tuple(stages) + (unit,), 0)
    for name, s, _ in trace.host:
        if name in SYNC_CALLS:
            stage = a.stage_of(a.innermost(s), unit, stages)
            if stage is not None:
                out[stage] += 1
    n = len(a.units(unit))
    return {k: v / n for k, v in out.items()}


def device_ms(trace, name: str) -> Optional[float]:
    """Mean device ms between the two events of the spans ``name``."""
    a = aligned(trace)
    if a is None:
        return None
    ms = [s.device_ms for s in a.spans
          if s.name == name and s.device_ms is not None]
    return sum(ms) / len(ms) if ms else None
