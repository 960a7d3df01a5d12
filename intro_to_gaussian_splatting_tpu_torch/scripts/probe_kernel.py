"""Per-program cost probes of the card: kernels P1 and P2 (csrc/probe.cu).

The counterpart of the JAX package's ``scripts/probe_kernel.py``, at its
sizes:

  probe 1: a grid of 65,856 programs, each writing one (8, 256) block of
           zeros, the per-program overhead floor;
  probe 2: the same grid, each program reading 32-row windows of a
           (2^18, 128) record table at 8-aligned offsets and doing the
           rasterizer's alpha, scan and payload arithmetic on 256 lanes.

Run on a machine with an NVIDIA card:

    python -m intro_to_gaussian_splatting_tpu_torch.scripts.probe_kernel \
        [1|2|all]

Each probe prints the device time of each of three launches (from
``torch.profiler``, after one warm-up launch) and the median in ns per
program. Without a card it raises.
"""

from __future__ import annotations

import sys

from intro_to_gaussian_splatting_tpu_torch.device import resolve_device
from intro_to_gaussian_splatting_tpu_torch.ops.probe import (
    NT,
    probe_inputs,
    probe_window,
    probe_zero,
)
from intro_to_gaussian_splatting_tpu_torch.utils.profiling import (
    profile_device_time,
)


def _report(name: str, durs: list) -> None:
    median = sorted(durs)[len(durs) // 2] if durs else float("nan")
    print(f"{name} grid({NT}): {[round(d * 1e3, 4) for d in durs]} ms "
          f"-> {median / NT * 1e9:.2f} ns/program", flush=True)


def probe1(iters: int = 3) -> list:
    """P1's device time (s) per launch."""
    device = resolve_device(None)
    durs = profile_device_time(lambda: probe_zero(NT, device), iters=iters,
                               name_substr="probe_zero")
    _report("probe1 zero blocks", durs)
    return durs


def probe2(iters: int = 3) -> list:
    """P2's device time (s) per launch, on the probe's own inputs."""
    starts, counts, rec = probe_inputs(device=resolve_device(None))
    durs = profile_device_time(lambda: probe_window(starts, counts, rec),
                               iters=iters, name_substr="probe_window")
    _report("probe2 windows + scan", durs)
    return durs


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    which = argv[0] if argv else "all"
    if which not in ("1", "2", "all"):
        raise SystemExit("usage: probe_kernel [1|2|all]")
    if which in ("1", "all"):
        probe1()
    if which in ("2", "all"):
        probe2()
    return 0


if __name__ == "__main__":
    sys.exit(main())
