"""The span metrics (``gsbench/spans.py``) on a synthetic trace and
synthetic program spans whose clock is 5 s behind the trace's: the offset
found from the marks, each idle moment put down to its innermost span
(a gap cut at the span edges it crosses) and counted in its stage, syncs
counted inside unit spans only, and None without marks or with a
residual over the limit."""

from __future__ import annotations

import pytest

from gsbench import harness as H
from gsbench import spans as S
from gsbench import tracing
from intro_to_gaussian_splatting_tpu_torch.utils.profiling import SpanRecord

OFFSET_US = 5e6          # trace time = program time + OFFSET_US
MARK_US = 4.0            # the host time around one event record

# (id, name, parent, start, end, device ms) on the trace's clock (us):
# two steps, the first with its stages, and a step of an earlier attempt
# (traced_window's retries) outside the window
SPANS = [
    (0, "step", None, 1100, 9000, 7.5),
    (1, "render", 0, 1200, 4000, 2.5),
    (2, "project", 1, 1300, 2000, 0.5),
    (3, "backward", 0, 4100, 7000, 2.8),
    (4, "optimizer", 0, 7100, 8500, 1.3),
    (5, "step", None, 9100, 15000, 5.8),
    (6, "render", 5, 9200, 11000, 3.5),
]
EARLIER = (7, "step", None, -60000, -50000, 9.0)
# the same times as views: view > {project, bin, rasterize}
AS_VIEW = {"step": "view", "render": "project", "backward": "bin",
           "optimizer": "rasterize"}
VIEWS = [(i, AS_VIEW[n], p, s, e, ms) for i, n, p, s, e, ms in SPANS
         if n in AS_VIEW]
UNIT_OF = {0: 0, 1: 0, 2: 0, 3: 0, 4: 0, 5: 5, 6: 5, 7: 7}
# device operations; the idle gaps between them fall in: 1500-1900
# project, 3900-4200 render / step 0 / backward, 5000-5600 backward,
# 8600-8900 step 0, 12000-13000 step 5, 14500-15500 step 5 / no span,
# 16000-17000 no span
BUSY = [(1000, 1500), (1900, 3900), (4200, 5000), (5600, 8600),
        (8900, 12000), (13000, 14500), (15500, 16000), (17000, 20000)]
# (runtime call, start): two in stages of step 0, one outside every step,
# one asynchronous copy that does not block
CALLS = [("cudaStreamSynchronize", 1400), ("cudaStreamSynchronize", 7200),
         ("cudaMemcpy", 7300), ("cudaMemcpyAsync", 7400),
         ("cudaStreamSynchronize", 16200)]


def _marks(start, end):
    """Program-clock (ns) marks just after enter and just before exit."""
    return tuple((round((t - OFFSET_US) * 1e3),
                  round((t + MARK_US - OFFSET_US) * 1e3))
                 for t in (start, end - MARK_US))


def _records(spans=SPANS + [EARLIER], marks=True, view=False):
    if view:
        spans = VIEWS
    return [SpanRecord(i, name, parent, 12345, UNIT_OF[i],
                       round((s - OFFSET_US) * 1e3),
                       round((e - OFFSET_US) * 1e3),
                       _marks(s, e) if marks else (), ms)
            for i, name, parent, s, e, ms in spans]


def _trace(shift_us: float = 0.0, jitter=(0.0, 1.0, -1.0), view=False):
    """The window 1000-20000 us; an event record call in the middle of
    each mark of the window's spans, ``shift_us`` late for the first."""
    ev = [dict(ph="X", cat="cuda_runtime", name=tracing.WINDOW_MARK,
               ts=ts, dur=10.0) for ts in (990.0, 19990.0)]
    ev += [dict(ph="X", cat="kernel", name="k", ts=float(lo),
                dur=float(hi - lo)) for lo, hi in BUSY]
    ev += [dict(ph="X", cat="cuda_runtime", name=n, ts=float(ts), dur=20.0)
           for n, ts in CALLS]
    mids = sorted(t + MARK_US / 2 for _, _, _, s, e, _ in
                  (VIEWS if view else SPANS)
                  for t in (s, e - MARK_US))
    for i, mid in enumerate(mids):
        late = (shift_us if i == 0 else 0.0) + jitter[i % len(jitter)]
        ev.append(dict(ph="X", cat="cuda_runtime", name=S.MARKS[-1],
                       ts=mid + late - 1.0, dur=2.0))
    return tracing.reduce_trace(ev)


def test_offset_found_from_the_marks():
    a = S.align(_records(), _trace())
    assert a.offset_us == pytest.approx(OFFSET_US, abs=1e-3)
    assert a.residual_us == 0.0
    # the earlier attempt's step lies outside the window
    assert [s.id for s in a.spans] == [0, 1, 2, 3, 4, 5, 6]
    assert [s.id for s in a.units("step")] == [0, 5]
    assert (a.spans[2].start, a.spans[2].end) == pytest.approx((1300, 2000))


def test_gaps_go_to_their_innermost_span(monkeypatch):
    trace = _trace()
    a = S.align(_records(), trace)
    assert a.innermost(1700).name == "project"
    assert a.innermost(16500) is None
    assert a.stage_of(a.innermost(1700), "step", S.TRAIN_STAGES) == "render"
    assert a.stage_of(a.innermost(1700), "view", S.VIEW_STAGES) is None
    assert [(us, s.name) for us, s in a.overlaps(3900, 4200)] == [
        (100, "render"), (100, "step"), (100, "backward")]
    monkeypatch.setattr(S, "_program_spans", _records)
    idle = S.idle_ms(trace, "step", S.TRAIN_STAGES)
    assert idle == pytest.approx(dict(render=0.25, backward=0.35,
                                      optimizer=0.0, step=0.95))
    # every idle moment inside a step counts once
    inside = sum(us for lo, hi in tracing.gaps(trace.intervals, trace.span)
                 for us, _ in a.overlaps(lo, hi)) * 1e-3
    assert sum(idle.values()) * 2 == pytest.approx(inside) == 3.1


def test_syncs_outside_a_unit_are_not_counted(monkeypatch):
    trace = _trace()
    monkeypatch.setattr(S, "_program_spans", _records)
    assert S.syncs(trace, "step", S.TRAIN_STAGES) == pytest.approx(
        dict(render=0.5, backward=0.0, optimizer=1.0, step=0.0))
    assert S.syncs(trace, "step") == dict(step=1.5)


@pytest.mark.parametrize("case", ["late_mark", "no_marks", "no_calls"])
def test_no_alignment_gives_none(case):
    if case == "late_mark":
        records, trace = _records(), _trace(shift_us=S.MAX_RESIDUAL_US + 5)
    elif case == "no_marks":
        records, trace = _records(marks=False), _trace()
    else:
        records = _records()
        trace = tracing.reduce_trace([
            e for e in _events_of(_trace()) if e["name"] not in S.MARKS])
    assert S.align(records, trace) is None


def _events_of(trace):
    out = [dict(ph="X", cat="kernel", name=n, ts=s, dur=e - s)
           for _, n, s, e in trace.device]
    out += [dict(ph="X", cat="cuda_runtime", name=n, ts=s, dur=e - s)
            for n, s, e in trace.host]
    return out


NEW = {
    "idle_ms.render.train": 0.25, "idle_ms.backward.train": 0.35,
    "idle_ms.optimizer.train": 0.0, "idle_ms.step.train": 0.95,
    "stage_device_ms.render.train": 3.0,
    "stage_device_ms.backward.train": 2.8,
    "stage_device_ms.optimizer.train": 1.3, "syncs_per_step.train": 1.5,
    "idle_ms.project.render": 0.25, "idle_ms.bin.render": 0.35,
    "idle_ms.rasterize.render": 0.0, "syncs_per_view.render": 1.5,
}


@pytest.mark.parametrize("name", sorted(NEW))
def test_every_span_metric_is_found_and_reads(name, monkeypatch):
    entry = next(m for m in H.benchmark()["per_layer"] if m["name"] == name)
    assert entry["source"] == "device_trace" and len(entry["workloads"]) == 1
    read = H.load_module(H.HERE / "metrics" / f"{name}.py").read
    view = name.endswith(".render")
    readings = H.Readings(trace=_trace(view=view), units=2,
                          untraced_s=0.02, counts={})
    monkeypatch.setattr(S, "_program_spans", lambda: _records(view=view))
    assert read(readings) == pytest.approx(NEW[name])
    # a program that records no spans, or spans without marks: nothing
    for records in (None, _records(marks=False, view=view)):
        monkeypatch.setattr(S, "_program_spans", lambda r=records: r)
        readings.trace = _trace(view=view)
        assert read(readings) is None
