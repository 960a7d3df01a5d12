"""The metric arithmetic on fixed records: the busy union and idle gaps,
launches, kernel times, rooflines and MFU, the window's rate and its
95th percentile over every view."""

from __future__ import annotations

import math

import numpy as np
import pytest

from gsbench import counts
from gsbench import harness as H
from gsbench import tracing

# a 10 ms window between two device-wide synchronisations: B1 twice
# (1 ms each), an overlapping copy, a gap at 7-11 ms in a stream sync
EVENTS = [
    dict(ph="X", cat="cuda_runtime", name=tracing.WINDOW_MARK, ts=990.0,
         dur=10.0),
    dict(ph="X", cat="cuda_runtime", name=tracing.WINDOW_MARK, ts=10500.0,
         dur=500.0),
    dict(ph="X", cat="kernel", name="void rasterize_fwd_kernel<16>",
         ts=1000.0, dur=1000.0),
    dict(ph="X", cat="gpu_memcpy", name="Memcpy DtoH", ts=1500.0,
         dur=1000.0),
    dict(ph="X", cat="kernel", name="void rasterize_fwd_kernel<16>",
         ts=4000.0, dur=1000.0),
    dict(ph="X", cat="kernel", name="fused_loss_kernel", ts=5000.0,
         dur=2000.0),
    dict(ph="X", cat="cuda_runtime", name="cudaStreamSynchronize",
         ts=7000.0, dur=3000.0),
    dict(ph="X", cat="kernel", name="outside", ts=20000.0, dur=5.0),
]


def _trace():
    return tracing.reduce_trace(EVENTS)


def test_busy_union_gaps_and_launches():
    t = _trace()
    assert t.window_s == pytest.approx(0.010)
    # busy 1000-2500, 4000-7000
    assert t.busy_s == pytest.approx(0.0045)
    assert tracing.gaps(t.intervals, t.span) == [(2500.0, 4000.0),
                                                 (7000.0, 11000.0)]
    assert t.launches() == 3 and t.launches("rasterize_fwd") == 2
    gaps = dict(t.idle_gaps())
    assert gaps["cudaStreamSynchronize"] == pytest.approx(0.004)
    assert gaps["host outside any runtime call"] == pytest.approx(0.0015)
    ops = dict(t.device_ops())
    assert ops["fused_loss_kernel"] == pytest.approx(0.002)


def test_no_window_gives_no_trace():
    assert tracing.reduce_trace([]) is None
    assert tracing.reduce_trace([dict(ph="i", name="marker", ts=0.0)]) is None


def test_without_two_marks_the_window_is_the_trace_extent():
    t = tracing.reduce_trace(EVENTS[2:])
    assert t.span == (1000.0, 20005.0)
    assert t.launches() == 4


def _readings(**counts_):
    c = dict(evaluations=1e9, pairs_read=4e6, pairs=3e7,
             nonempty_tiles=60000, width=5068, height=3324, tiles=65936,
             tile_size=16, slots=52363, sh_degree=3, sh_coeffs=16)
    c.update(counts_)
    return H.Readings(trace=_trace(), units=2, untraced_s=0.008, counts=c,
                      stage_ms=dict(render=3.0))


def _read(name, r):
    return H.load_module(H.HERE / "metrics" / f"{name}.py").read(r)


def test_roofline_mfu_idle_and_launches():
    r = _readings()
    b1_bytes = 4 * 11 * 4e6 + 8 * 65936 + 4 * 5 * 65936 * 256
    want = max(b1_bytes / 3.35e12, 30 * 1e9 / 67e12) * 1e3 / 1.0 * 100
    assert _read("b1_roofline.train", r) == pytest.approx(want)
    assert _read("b1_roofline.render", r) == pytest.approx(want)
    b3 = max(3 * 4 * 3 * 5068 * 3324 / 3.35e12,
             counts.B3_OPS_PER_PIXEL * 3 * 5068 * 3324 / 67e12) * 1e3
    assert _read("b3_roofline.train", r) == pytest.approx(b3 / 2.0 * 100)
    assert _read("b2_roofline.train", r) is None
    assert _read("idle_share.train", r) == pytest.approx(43.75)
    assert _read("launches_per_step.train", r) == pytest.approx(1.5)
    assert _read("stage_ms.render.train", r) == 3.0
    assert _read("stage_ms.backward.train", r) is None
    ops = counts.train_step_ops(r.counts, 5068, 3324, 52363, 3, 16)
    assert _read("step_mfu.train", r) == pytest.approx(
        100 * ops / 0.004 / 67e12)
    assert 0 < _read("view_mfu.render", r) < 100


def test_window_rate_and_p95_over_every_view():
    lat = [0.010] * 95 + [0.100] * 5
    assert float(np.percentile(lat, 95)) == pytest.approx(0.0145)
    assert len(lat) / 2.0 == 50.0


def test_outcome_correct_needs_every_number_under_its_limit():
    ok = H.Outcome({}, 1, 0, dict(a=(1e-6, 1e-4), b=(0, 0)))
    assert ok.correct
    assert not H.Outcome({}, 1, 0, dict(a=(2e-4, 1e-4))).correct
    assert not H.Outcome({}, 1, 0, dict(a=(math.nan, 1e-4))).correct
    assert not H.Outcome({}, 1, 1, dict(a=(1e-6, 1e-4))).correct
