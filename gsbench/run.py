#!/usr/bin/env python3
"""One run of one cell of the port's benchmark, on the card it starts on.

    python3 gsbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device`` and, last,
``checks``: each number compared with the plain reference beside its
limit, also the last lines of standard error. Exits non-zero with no
result where the card, or enough cards, or the port is missing, and where
the process holds JAX or the JAX package after the window.

``--control 1`` runs the check's control instead of the program: the
reference computed in TF32, compared with the reference in float32. It has
to come out not correct.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
# the program's kernel builds, kept in fixed directories of the checkout
os.environ["GSTPU_TORCH_BUILD_DIR"] = str(HERE / "_build" / "kernels")
os.environ["TRITON_CACHE_DIR"] = str(HERE / "_build" / "triton")
sys.path.insert(0, str(HERE.parent))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if args.seed < 0:
        p.error("--seed must be a whole number >= 0")
    return args


def load_cell(bench, name: str, seed: int, seconds: float, trace: bool,
              device, root: Path = HERE):
    """(Cell, chips) of the cell ``name``: its workload file and its
    configuration's file, found by name under ``root``."""
    from gsbench import harness as H

    entry = H.cell_entry(bench, name)
    workload = H.load_json(root / "workloads" / f"{name}.json")
    if (workload["config"], workload["traffic"]) != (entry["config"],
                                                     entry["traffic"]):
        raise SystemExit(f"{name}: the workload file and BENCHMARK.json "
                         f"name different cells")
    config = H.load_json(root / "configs" / f"{entry['config']}.json")
    cell = H.Cell(name=name, config=config, traffic=workload["traffic"],
                  params=workload["params"], limits=workload["limits"],
                  seed=seed, seconds=seconds, trace=trace, device=device,
                  t_start=T_START)
    return cell, int(entry["chips"])


def main(argv=None) -> int:
    args = parse(argv)
    from gsbench import harness as H

    bench = H.benchmark()
    import torch

    cell, chips = load_cell(bench, args.workload, args.seed, args.seconds,
                            bool(args.trace), torch.device("cuda", 0))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count()={torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    try:
        importlib.import_module(H.PACKAGE)
    except ImportError as e:
        print(f"the program {H.PACKAGE} is missing: {e}", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    return report(bench, cell, chips, control=bool(args.control))


def report(bench, cell, chips: int, control: bool = False) -> int:
    """Run ``cell`` (or its control), print the result; the exit code."""
    from gsbench import harness as H

    traffic = H.load_module(HERE / "traffic" / f"{cell.traffic}.py")
    outcome = traffic.control(cell) if control else traffic.run(cell)
    setup_s = outcome.end_to_end.pop("setup_s", 0.0)
    line = H.result_line(bench, cell, outcome, chips, setup_s)
    found = H.forbidden_modules()
    if found:
        print(f"the process holds JAX or the JAX package: {found}",
              file=sys.stderr)
        return 3
    for name, (value, limit) in outcome.checks.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
