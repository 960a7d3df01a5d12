"""What every cell shares: finding a cell's files by name, the run's
``Cell`` and ``Outcome``, the per-layer readings, and the result line.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``. Its files are
found by name: ``workloads/<cell>.json`` (its traffic kind, parameters and
limits), ``configs/<config>.json`` (the scene as it is run),
``traffic/<kind>.py`` (the generator that drives the program) and, for
each per-layer metric, ``metrics/<metric>.py`` (a ``read(readings)``
returning the value, or None where it finds nothing to read).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
PACKAGE = "intro_to_gaussian_splatting_tpu_torch"
# top-level module names the process must not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "intro_to_gaussian_splatting_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module from a file path (metric and traffic names hold dots)."""
    name = "gsbench_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def benchmark(path: Optional[Path] = None) -> dict:
    return load_json(path or REPO / "BENCHMARK.json")


def cell_entry(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def end_to_end_metrics(bench: dict, cell: str) -> List[dict]:
    return [m for m in bench["end_to_end"] if applies(m, cell)]


def per_layer_metrics(bench: dict, cell: str) -> List[dict]:
    """The per-layer metrics of ``cell``: those that list it, and those
    without a list that move an end-to-end metric the cell reports."""
    reported = {m["name"] for m in end_to_end_metrics(bench, cell)}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in reported)]


def forbidden_modules() -> List[str]:
    """Names in ``sys.modules`` whose top-level name is forbidden."""
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: str
    params: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: object                 # torch.device
    t_start: float                 # perf_counter at process start
    log: Callable[[str], None] = lambda msg: print(msg, file=sys.stderr)

    def rasterizer(self) -> dict:
        """The rasterizer settings: the configuration's, then the cell's."""
        return dict(self.config["rasterizer"],
                    **self.params.get("rasterizer", {}))


@dataclasses.dataclass
class Readings:
    """What a traced run gives the per-layer metrics: the trace, the units
    of work traced (steps or views), the host seconds of as many units run
    untraced just before them, the work each needs as the reference counts
    it (mean over the units), and the stage times."""
    trace: object                  # tracing.Trace
    units: int
    untraced_s: float
    counts: dict
    stage_ms: Dict[str, float] = dataclasses.field(default_factory=dict)

    def kernel_ms(self, substr: str) -> Optional[float]:
        """Mean device ms per launch of the kernels named ``substr``."""
        secs = self.trace.kernel_seconds(substr)
        return 1e3 * sum(secs) / len(secs) if secs else None


@dataclasses.dataclass
class Outcome:
    end_to_end: Dict[str, float]
    attempted: int
    failed: int
    checks: Dict[str, tuple]       # name -> (value, limit)
    memory_peak: int = 0
    readings: Optional[Readings] = None

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(
            math.isfinite(v) and v <= lim for v, lim in self.checks.values())


def sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def relative_gap(got: float, want: float, scale: float) -> float:
    return abs(got - want) / scale if scale > 0 else abs(got - want)


def device_info(device, count: int, memory_peak: int) -> dict:
    import torch
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    return dict(platform="gpu" if device.type == "cuda" else "cpu",
                kind=kind, count=count, memory_peak_bytes=int(memory_peak))


def read_per_layer(metrics: List[dict], readings: Readings) -> dict:
    out = {}
    for m in metrics:
        value = load_module(HERE / "metrics" / f"{m['name']}.py").read(
            readings)
        if value is not None:
            out[m["name"]] = dict(value=value, unit=m["unit"])
    return out


def result_line(bench: dict, cell: Cell, outcome: Outcome, count: int,
                setup_s: float) -> dict:
    """The last line's object: correct, attempted, failed, metrics,
    device (and with a trace busy_s, window_s and the breakdown), and the
    numbers compared with their limits last."""
    units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
    if cell.trace:
        metrics = read_per_layer(per_layer_metrics(bench, cell.name),
                                 outcome.readings)
    else:
        values = dict(outcome.end_to_end, setup_s=setup_s)
        metrics = {m["name"]: dict(value=values[m["name"]],
                                   unit=units[m["name"]])
                   for m in end_to_end_metrics(bench, cell.name)
                   if m["name"] in values}
    device = device_info(cell.device, count, outcome.memory_peak)
    line = dict(correct=outcome.correct, attempted=outcome.attempted,
                failed=outcome.failed, metrics=metrics, device=device)
    if cell.trace and outcome.readings is not None:
        trace = outcome.readings.trace
        device.update(busy_s=trace.busy_s, window_s=trace.window_s)
        line["breakdown"] = dict(device_ops=trace.device_ops(),
                                 idle_gaps=trace.idle_gaps())
    line["checks"] = {k: dict(value=v, limit=lim)
                      for k, (v, lim) in outcome.checks.items()}
    return line
