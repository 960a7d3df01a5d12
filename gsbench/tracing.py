"""One traced window under ``torch.profiler`` and what the per-layer
metrics read from it.

``traced_window(fn, expect)`` runs ``fn()`` under the profiler with
device activity alone (CUPTI: device operations and the CUDA runtime
calls that launched them). Recording every host operation too would cost
the host several microseconds per operation and stretch a launch-bound
step by half or more, so that the idle share would read the profiler's
own time. The window opens and closes with a ``synchronize()``; its span
on the trace's clock runs from the end of the first device-wide
synchronisation to the end of the last. The Chrome trace is exported into
the run's temporary directory and reduced to a ``Trace``: the window's
span, every device operation (kernels, copies, sets) inside it, the union
of their intervals (busy time), the idle gaps between them, each labelled
by the runtime call running at the gap's middle (or none), and the kernel
launches. The profiler can drop a session's device records with no error;
where the trace holds fewer launches of a kernel than the program's own
counter says ``fn`` made (``expect``: name substring -> launches), the
window is traced again, three times at most.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import os
import tempfile
from typing import Callable, Dict, List, Optional, Tuple

# the runtime call a device-wide synchronize() makes: the window's marks
WINDOW_MARK = "cudaDeviceSynchronize"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
# host calls looked at, backwards from a gap's middle, for the one that
# covers it
_LOOKBACK = 400


@dataclasses.dataclass
class Trace:
    window_s: float
    device: List[Tuple[str, str, float, float]]   # (cat, name, start, end) us
    host: List[Tuple[str, float, float]]          # (name, start, end) us
    span: Tuple[float, float]

    @property
    def intervals(self):
        return [(s, e) for _, _, s, e in self.device]

    @property
    def busy_s(self) -> float:
        return union_seconds(self.intervals, self.span)

    def launches(self, substr: str = "") -> int:
        return sum(1 for cat, name, _, _ in self.device
                   if cat == "kernel" and substr in name)

    def kernel_seconds(self, substr: str) -> List[float]:
        return [(e - s) / 1e6 for cat, name, s, e in self.device
                if cat == "kernel" and substr in name]

    def device_ops(self, top: int = 10):
        total = collections.defaultdict(float)
        for _, name, s, e in self.device:
            total[name] += (e - s) / 1e6
        return sorted(([n[:120], v] for n, v in total.items()),
                      key=lambda x: -x[1])[:top]

    def idle_gaps(self, top: int = 10):
        total = collections.defaultdict(float)
        starts = [h[1] for h in self.host]
        for lo, hi in gaps(self.intervals, self.span):
            total[_label(self.host, starts, 0.5 * (lo + hi))] += (
                (hi - lo) / 1e6)
        return sorted(([n, v] for n, v in total.items()),
                      key=lambda x: -x[1])[:top]


def union_seconds(intervals, span) -> float:
    """Length (s) of the union of ``intervals`` (us) clipped to ``span``."""
    lo_w, hi_w = span
    total, cur_lo, cur_hi = 0.0, None, None
    for lo, hi in sorted(intervals):
        lo, hi = max(lo, lo_w), min(hi, hi_w)
        if hi <= lo:
            continue
        if cur_hi is None or lo > cur_hi:
            if cur_hi is not None:
                total += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    if cur_hi is not None:
        total += cur_hi - cur_lo
    return total / 1e6


def gaps(intervals, span):
    """The idle intervals (us) of ``span`` outside every interval."""
    out, cursor = [], span[0]
    for lo, hi in sorted(intervals):
        lo, hi = max(lo, span[0]), min(hi, span[1])
        if hi <= lo:
            continue
        if lo > cursor:
            out.append((cursor, lo))
        cursor = max(cursor, hi)
    if cursor < span[1]:
        out.append((cursor, span[1]))
    return out


def _label(host, starts, t) -> str:
    """The innermost (shortest) host operation covering time ``t``."""
    i = bisect.bisect_right(starts, t)
    best = None
    for name, s, e in reversed(host[max(0, i - _LOOKBACK):i]):
        if e >= t and (best is None or e - s < best[1]):
            best = (name, e - s)
    return best[0] if best else "host outside any runtime call"


def window_span(events: list) -> Optional[Tuple[float, float]]:
    """(start, end) us of the window: from the end of the first
    device-wide synchronisation to the end of the last; without two such
    marks, the extent of every timed event. None for an empty trace."""
    timed = [e for e in events if e.get("ph") == "X" and "dur" in e]
    marks = sorted(float(e["ts"]) + float(e["dur"]) for e in timed
                   if e.get("name") == WINDOW_MARK)
    if len(marks) >= 2:
        return marks[0], marks[-1]
    if not timed:
        return None
    return (min(float(e["ts"]) for e in timed),
            max(float(e["ts"]) + float(e["dur"]) for e in timed))


def reduce_trace(events: list) -> Optional[Trace]:
    """A ``Trace`` of Chrome-trace ``events``; None for an empty trace."""
    span = window_span(events)
    if span is None:
        return None
    lo, hi = span
    device, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s = float(e["ts"])
        end = s + float(e["dur"])
        if end < lo or s > hi:
            continue
        if e.get("cat") in DEVICE_CATS:
            device.append((e["cat"], e["name"], s, end))
        elif e.get("cat") in HOST_CATS:
            host.append((e["name"], s, end))
    host.sort(key=lambda h: h[1])
    return Trace(window_s=(hi - lo) / 1e6, device=device, host=host,
                 span=(lo, hi))


def traced_window(fn: Callable, sync: Callable,
                  expect: Optional[Dict[str, Callable[[], int]]] = None,
                  tries: int = 3):
    """(Trace, fn's result). ``expect`` maps a
    kernel-name substring to a function giving how many launches ``fn``
    made (read after it). Without a card (the CPU tests) the profiler
    records host operations, the only activity there is."""
    import torch

    acts = ([torch.profiler.ProfilerActivity.CUDA]
            if torch.cuda.is_available()
            else [torch.profiler.ProfilerActivity.CPU])
    for attempt in range(tries):
        before = {k: f() for k, f in (expect or {}).items()}
        sync()
        with torch.profiler.profile(activities=acts) as prof:
            sync()
            result = fn()
            sync()
        made = {k: f() - before[k] for k, f in (expect or {}).items()}
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        trace = reduce_trace(events)
        if trace is not None and all(
                trace.launches(k) >= n for k, n in made.items()):
            return trace, result
    return trace, result
