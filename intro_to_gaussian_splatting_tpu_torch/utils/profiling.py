"""Profiling, timing and the card's ceilings.

The port's counterpart of the JAX package's ``utils/profiling.py``:

  * ``trace(...)``         a context manager around ``torch.profiler`` that
                           writes a Chrome trace (``trace.json``) into a
                           directory;
  * ``benchmark(...)``     wall time per call with the card synchronised,
                           the first call (where the kernels build) timed
                           apart;
  * ``profile_device_time(...)``  the device durations of the CUDA kernels
                           whose name contains a substring, read from
                           ``torch.profiler``'s events;
  * ``device_ms_in_turns(...)``  two functions' mean kernel durations
                           from ``torch.profiler``, timed in turns;
  * ``device_ms_per_call(...)``  one function's device time per call
                           under ``torch.profiler``, by kernel name;
  * ``cuda_ms``, ``device_profile``  a function's mean device time from
                           CUDA events, and one call's kernel time, wall
                           time and idle share under the profiler;
  * ``HBM_BYTES_PER_S``, ``FP32_FLOP_PER_S`` and ``bound``: the least time
                           the card could take for a given number of bytes
                           and float32 operations.

The JAX package's TPU roofline (MXU passes, VPU ratio, ``TPU_PEAKS``)
describes a TPU and has no counterpart here.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

# Published peaks of one H100 SXM (NVIDIA data sheet), at its 700 W limit:
# HBM3 bandwidth and float32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def bound(nbytes: float, ops: float):
    """(ms, binding resource): the larger of ``nbytes`` over the HBM rate
    and ``ops`` float32 operations over the f32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True):
    """``with trace(dir): run_step()`` -> ``dir/trace.json``, a Chrome trace
    of the host ops and, where there is a card, its kernels."""
    if not enabled:
        yield
        return
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=_activities()) as prof:
        yield
        _sync()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@dataclasses.dataclass
class BenchResult:
    mean_s: float
    min_s: float
    std_s: float
    iters: int
    first_s: float     # the first call, kernels built and loaded in it

    def mpix_per_s(self, width: int, height: int) -> float:
        return width * height / 1e6 / self.mean_s


def benchmark(fn: Callable, *args, iters: int = 10, warmup: int = 2,
              **kwargs) -> BenchResult:
    """Time ``fn(*args, **kwargs)`` on a host clock, each call ending in a
    synchronise of the card. The first call is timed apart (``first_s``):
    the kernels build and load in it."""
    t0 = time.perf_counter()
    fn(*args, **kwargs)
    _sync()
    first_s = time.perf_counter() - t0
    for _ in range(max(0, warmup - 1)):
        fn(*args, **kwargs)
    _sync()
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        _sync()
        samples.append(time.perf_counter() - t0)
    s = np.asarray(samples)
    return BenchResult(mean_s=float(s.mean()), min_s=float(s.min()),
                       std_s=float(s.std()), iters=iters, first_s=first_s)


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


def device_ms_in_turns(a, b, per_turn: int = 15):
    """``a`` and ``b`` timed in turns (a, b, b, a; ``per_turn`` calls
    each), each turn under its own torch.profiler session, so that a
    comparison is made on one card at one time. Returns, for each, the
    mean device duration (ms) of the CUDA kernels its calls launched and
    how many the profiler timed."""
    a()
    b()
    _sync()
    durs = ([], [])
    for i in (0, 1, 1, 0):
        with torch.profiler.profile(activities=_activities()) as prof:
            for _ in range(per_turn):
                (a, b)[i]()
            _sync()
        durs[i].extend(e.device_time_total / 1e3
                       for e in _kernel_events(prof))
    return tuple((sum(d) / len(d) if d else float("nan"), len(d))
                 for d in durs)


def device_ms_per_call(fn, calls: int = 24, warmup: int = 1) -> dict:
    """``fn`` called ``calls`` times under torch.profiler. Returns, for
    each kernel (or copy) name its calls launched, (device ms per call,
    launches timed): the name's mean duration times its launches per
    call, so that a launch the profiler misses does not count as no
    time."""
    for _ in range(warmup):
        fn()
    _sync()
    with torch.profiler.profile(activities=_activities()) as prof:
        for _ in range(calls):
            fn()
        _sync()
    durs = {}
    for e in _kernel_events(prof):
        durs.setdefault(e.name, []).append(e.device_time_total / 1e3)
    return {name: (sum(d) / len(d) * max(1, round(len(d) / calls)), len(d))
            for name, d in durs.items()}


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


def device_profile(fn, named: Optional[dict] = None) -> dict:
    """One call of ``fn`` under torch.profiler: its wall ms, the ms the
    card spent in kernels, the idle share, the five longest kernels and,
    for each ``label: name`` of ``named``, the ms and launches of the
    kernels whose names contain ``name``."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=_activities()) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:5]
    by_label = {
        label: [sum(e.self_device_time_total for e in kernels
                    if name in e.key) / 1e3,
                sum(e.count for e in kernels if name in e.key)]
        for label, name in (named or {}).items()}
    return dict(wall_ms=wall_ms, kernel_ms=busy_ms,
                idle_share=max(0.0, 1.0 - busy_ms / wall_ms),
                kernel_launches=sum(e.count for e in kernels),
                top_kernels=[[e.key[:80], e.self_device_time_total / 1e3,
                              e.count] for e in top],
                named_kernel_ms=by_label)
