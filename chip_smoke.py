#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port: the render path, the training
step with the fused or the split loss, batched steps, the probe kernels,
checkpoint / resume, evaluation, training over a device mesh, the CLI,
the host C++ and the training-curve run.

Run from the root of a checkout, on a machine with one NVIDIA card:

    python3 chip_smoke.py

It imports only the port (``intro_to_gaussian_splatting_tpu_torch``), never
JAX, and prints one JSON line per phase:

  device          card name and power limit, torch and CUDA versions, the
                  build of all thirteen kernels (one nvcc per source, started
                  together) and ptxas's register / shared-memory / spill
                  report;
  small_batched   ``train_step_batched`` over two cameras on the card: its
                  Adam step is on the mean of the two cameras' gradients;
  small_trainer   six steps of ``Trainer.run`` on the card, that scene in a
                  pool with free slots: densify, prune and the opacity
                  reset run, the logged metrics come back;
  ref_init        the treehill-scale scene (52,363 gaussians at 5068x3324,
                  built as bench.py builds it) at the reference init,
                  through ``ops.render.render(backend="auto")`` with the
                  render kernels' launch counts (J1, B1, B5-untile) set to
                  0 just before and read just after;
  knn_init        the same scene at the KNN scale init with the dense pool
                  (pairs_per_gaussian=585, group_tiles=16, groups_per_step=16);
  *_kernels       per scene, B1 and B5-untile against their plain versions
                  on the scene's real inputs (B1 within rtol 1e-4, its
                  bit-equality reported beside the gate), their times (B1's
                  device ms
                  per call under torch.profiler, at least 20 launches
                  timed, the CUDA-event ms beside it, as for every B1-B4
                  row; B5-untile and its library call timed in turns,
                  torch.profiler's device durations with the CUDA-event
                  figures beside them, bytes and GB/s), bounds, plain and
                  library times; at ref_init also ``render_tiled`` at
                  ``group_tiles=1`` (65,936 groups) exactly equal to the
                  default render;
  train_ref_init  ten ``train_step``s at that scene (bench.py's gradient
                  target, ``TrainConfig()``), every launch count set to 0
                  just before and read just after: per step loss, PSNR and
                  launches of J1, B1, B2, B3, G1 and J2; step time on a
                  host clock around synchronised steps (mean of steps
                  2-10) and as Mpix/s; peak memory;
  train_knn_init  the same at the KNN init and the dense pool; both also
                  time one densify + prune pass (``Trainer._densify_and_
                  prune``) after their steps, host ms between two
                  synchronisations, on copies of the trained model: as it
                  is (every slot active) and in a pool of twice its
                  capacity, with the slots written;
  render_grad_*   the gradient of a ``render_tiled`` image on the card, the
                  path that launches B5-tile, counted the same way;
  train_kernels_* per scene, on the step's real inputs, B2, B3 and B5-tile
                  against their plain versions, with times (at both
                  scenes), bounds, plain times and (B5-tile, timed as
                  B5-untile) the library call's; the step's gradients
                  from two backward passes bit for bit equal;
  g1_kernel       G1, the gather's backward, at two shapes (one line
                  each, ``shape``): the treehill_3dgs train cell's (the
                  KNN init in a pool of 4x its gaussians, 256 pairs per
                  gaussian: 53.6M slots) and the treehill_3dgs_30k
                  cell's (3.1M gaussians of its scene recipe at
                  1267x831, 16 pairs per gaussian: 49.6M slots), on a
                  seeded cotangent: against its plain version (the
                  library chain it replaced) and the float64 block sums,
                  exact zeros, bit for bit on repeat, each rank's sums in
                  its gaussian's column, one launch per call; its ms
                  beside its bound and the plain chain's ms;
  projection_kernels_render, projection_kernels_train  J1 and J2 at the
                  render cell's 52,363 gaussians and the train cell's
                  pool of 4x, SH 3, seeded rotations, scales and
                  coefficients: J1 against its plain version (radius and
                  valid equal, each float field's ulps), J2 against
                  autograd through it (relative L2 1e-5, exact zeros, bit
                  for bit on repeat), one launch each per call; ms beside
                  the bound and the plain chain's ms;
  ssim_kernels    B4a, B4b and B4c against their plain versions on seeded
                  3x3324x5068 images (B4b and B4c at both grad_target
                  settings), B4c's value B4a's bit for bit, times (B4a's
                  two kernels apart), bounds, plain times; the
                  one-pass path ``fused_ssim(precompute_grad=True)`` under
                  autograd, counted (B4c once);
  train_split_ref_init    ten split-loss ``train_step``s at ref_init, each
                  launching J1, B1, B2, B4a, B4b, B5-untile, B5-tile, G1
                  and J2 once and B3 never, counted from 0 as above;
  train_batched_ref_init  five ``train_step_batched`` steps over two ring
                  cameras at ref_init, each launching J1, B1, B2, B3, G1
                  and J2 twice;
  probes          the port's probe script (P1, P2 at 65,856 programs) with
                  the counts set to 0 just before and read just after, P1
                  exactly zero, P2 against its plain version on the
                  script's inputs and on seeded random ones, times from
                  CUDA events and torch.profiler, bounds, P2's issue-slot
                  floor (the instructions of its row loop in the built
                  kernel's SASS, cuobjdump), plain times, P1's library
                  call;
  checkpoint_ref_init  ten ``Trainer`` steps at ref_init saving at steps 5
                  and 10, a fresh Trainer resumed from step 5 to 10
                  bit-equal to them, retention, save / load ms and bytes;
  eval_ref_init   ``evaluate`` on two ring cameras at 5068x3324 (B1 and
                  B5-untile once per view) against PSNR / SSIM recomputed
                  from ``render_tiled``, and a PLY export / import / render
                  round trip;
  mesh_ref_init   the mesh path (parallel/) in a world of one rank on the
                  card, through NCCL, at the ref_init scene, ``ring=True``:
                  the first step's loss and gradients (parameters and the
                  densify probe) against the single-card ``train_step``'s
                  on the same model (loss rel 1e-5, relative L2 1e-4), bit
                  for bit the same on repeat, ``ring=False`` against
                  ``ring=True`` (its bit-equality reported); then ten
                  ``sharded_train_step``s counted from 0 as above (B1 and
                  B2 once per step, B3 never; the loss falling), step ms
                  beside the single-card step's, peak memory;
  mesh_knn_init   the same at the KNN init and the dense pool;
  mesh_trainer_small  ``Trainer(mesh=...)`` at the small scene: six steps
                  with densify, prune and the opacity reset; a mesh
                  checkpoint / resume bit-equal to the straight run, and
                  the mesh's checkpoint resumed by a single-card Trainer,
                  equal too;
  mesh_2rank_ref_init  with two cards or more, a 2-rank NCCL mesh in two
                  processes of this script at ref_init: the losses
                  identical on both ranks, the first step's loss and
                  gathered gradients equal to the 1x1 mesh's; with one card
                  a line that says it did not run, and why;
  cli_small       ``cli.main`` in-process on a small synthetic scene: info,
                  train, train --resume, eval, points and train
                  --multihost in a world of one rank, on the card;
  native          the port's host C++ (utils/native.py), built with g++:
                  the scalar CPU oracle on the small scene's depth-sorted
                  records (projected on the card, moved to the host)
                  against the card's ``render_tiled`` (B1) and
                  ``render_dense`` (rtol 1e-4, atol 1e-5); the native
                  COLMAP readers equal to the Python readers on a
                  4,000-point model; host ms of each;
  native_fallback with ``CXX=false`` and an empty build directory,
                  ``read_model`` of that model through the Python parser:
                  one warning, nothing built, every array equal to the
                  native read's; host ms;
  train_curve     the port's training-curve script
                  (scripts/train_curve.py) in this process, at its
                  defaults (600 steps at 1392x928, 12,000 of 60,000
                  gaussians, densify every 100 steps): targets rendered on
                  the card, then the run with the launch counts set to 0
                  just before and read just after; every logged loss and
                  PSNR finite, PSNR climbing by more than 1 dB, B1, B2,
                  B3 and G1 exactly once per step, ``num_active`` moving at a
                  densify step; wall s, steps/s, PSNR first / best /
                  final, each pool growth and densify pass, peak memory
                  and the curve.

Every phase line carries ``phase_seconds``, the seconds since the line
before it. A kernel row's bound is the larger of its bytes over the HBM
rate and its operations over the float32 rate, the peaks of
``gsbench/counts.py``; B1, B2, B3 and B5-untile take their bytes and
operations from the counts there too, fed this run's own counts of the
scene (evaluations, pairs read, emitted pairs, tiles with pairs). The
stages of a training step or a view, and their idle time, are the
benchmark's to read from the program's spans (``gsbench/``).

Then the nvidia-smi line, the kernels summary line (B1 and B5-untile from
the ref_init render, B2 and B3 from the ref_init training run, B5-tile from
the ref_init render gradient, B4a and B4b from the split-loss run, B4c from
the one-pass SSIM path, P1 and P2 from the probe script, G1 at both of
its phase's shapes, J1 and J2 from theirs at the train cell's shape)
and, last, the contract line. Any failed check exits non-zero before the
last line; with no card, or outside a checkout, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import types
import warnings
from pathlib import Path

REPO = Path(__file__).resolve().parent
PACKAGE = "intro_to_gaussian_splatting_tpu_torch"

# Pair counts the JAX package gives on the same inputs (its bench.py).
JAX_PAIRS = {"ref_init": 81513, "knn_init": 29146684}

B1_REPLACES = "intro_to_gaussian_splatting_tpu/ops/rasterize_pallas.py:220"
B2_REPLACES = "intro_to_gaussian_splatting_tpu/ops/rasterize_pallas.py:333"
B3_REPLACES = "intro_to_gaussian_splatting_tpu/ops/fused_loss_pallas.py:112"
B5_REPLACES = "intro_to_gaussian_splatting_tpu/ops/relayout_pallas.py:59"
B5_TILE_REPLACES = "intro_to_gaussian_splatting_tpu/ops/relayout_pallas.py:89"
B4A_REPLACES = "intro_to_gaussian_splatting_tpu/ops/ssim_pallas.py:104"
B4B_REPLACES = "intro_to_gaussian_splatting_tpu/ops/ssim_pallas.py:156"
B4C_REPLACES = "intro_to_gaussian_splatting_tpu/ops/ssim_pallas.py:210"

# Operations kernel B4a does per pixel and channel, counted as
# gsbench/counts.py counts B3's: x^2, y^2, xy (3); the five 11-tap blurs
# down and along (2 x 5 x 21); the SSIM terms (22). B4b adds the three
# window coefficients (15), the three adjoint blurs along and down
# (2 x 3 x 21) and the gradient (6); B4c adds the value (1).
B4A_OPS_PER_PIXEL = 3 + 2 * 5 * 21 + 22
B4B_OPS_PER_PIXEL = B4A_OPS_PER_PIXEL + 15 + 2 * 3 * 21 + 6
B4C_OPS_PER_PIXEL = B4B_OPS_PER_PIXEL + 1

# Steps of the train_curve phase: the port's script at its defaults.
TRAIN_CURVE_STEPS = 600

P1_REPLACES = "scripts/probe_kernel.py:31"
P2_REPLACES = "scripts/probe_kernel.py:55"


_PHASE_CLOCK = [time.perf_counter()]


def emit(phase: str, **fields) -> None:
    """One phase's JSON line, with the seconds since the previous line."""
    now = time.perf_counter()
    fields["phase_seconds"] = now - _PHASE_CLOCK[0]
    _PHASE_CLOCK[0] = now
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: check failed: {what}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def bound_of(M, nbytes, ops):
    """(ms, binding resource): ``gsbench/counts.py``'s least time for
    ``nbytes`` and ``ops`` float32 operations, and which of the two sets
    it."""
    t_bytes, t_ops = M.K.bound_ms(nbytes, 0), M.K.bound_ms(0, ops)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def in_turns(M, kernel, library, per_turn=15):
    """A B5 kernel and its library call timed in turns (kernel, library,
    library, kernel; ``per_turn`` calls each, the round repeated while the
    profiler has timed fewer than 20 launches of either): the mean device
    durations under torch.profiler and how many launches it timed, then
    the same turns from CUDA events."""
    (ms, n), (lib_ms, lib_n), rounds = M.U.device_ms_in_turns(
        kernel, library, per_turn, min_launches=20)
    events = ([], [])
    for i in (0, 1, 1, 0):
        events[i].append(M.U.cuda_ms((kernel, library)[i], iters=per_turn))
    return dict(ms=ms, profiler_launches=n, profiler_rounds=rounds,
                cuda_event_ms=sum(events[0]) / 2, library_ms=lib_ms,
                library_profiler_launches=lib_n,
                library_cuda_event_ms=sum(events[1]) / 2)


def profiled(M, fn, names, calls=24):
    """A B1-B4 kernel's time: its wrapper called ``calls`` times under
    torch.profiler, the device ms per call of the kernels whose names
    contain one of ``names`` (at least 20 launches of the first must be
    timed; a session that timed fewer is run again), each name's share
    apart, and the wrapper's mean time from CUDA events beside it."""
    def first_timed(by_name):
        return sum(v[1] for n, v in by_name.items() if names[0] in n)

    by_name = M.U.device_ms_per_call(
        fn, calls, timed=lambda r: first_timed(r) >= 20)
    mine = {n: v for n, v in by_name.items() if any(k in n for k in names)}
    timed = first_timed(by_name)
    check(timed >= 20, f"{names[0]}: the profiler timed {timed} of {calls} "
                       f"launches ({sorted(by_name)})")
    return dict(ms=sum(v[0] for v in mine.values()), profiler_launches=timed,
                kernel_ms={k: sum(v[0] for n, v in mine.items() if k in n)
                           for k in names},
                cuda_event_ms=M.U.cuda_ms(fn, iters=10))


def b5_row(times, nbytes, library_bytes, **fields):
    """A B5 kernel row: the profiler's means, the CUDA-event figures beside
    them, and bytes moved and GB/s for the kernel and its library call."""
    check(times["profiler_launches"] >= 20
          and times["library_profiler_launches"] >= 20,
          f"{fields['name']}: the profiler timed fewer than 20 launches: "
          f"{times}")
    return dict(fields, ms=times["ms"], bytes=nbytes,
                gbytes_per_s=nbytes / times["ms"] / 1e6,
                cuda_event_ms=times["cuda_event_ms"],
                profiler_launches=times["profiler_launches"],
                profiler_rounds=times["profiler_rounds"],
                library_ms=times["library_ms"], library_bytes=library_bytes,
                library_gbytes_per_s=library_bytes / times["library_ms"]
                / 1e6,
                library_cuda_event_ms=times["library_cuda_event_ms"],
                library_profiler_launches=times["library_profiler_launches"])


SASS_INSTRUCTION = re.compile(r"/\*([0-9a-f]{4,})\*/\s+([^;]*?)\s*;")


def sass_inner_loop(sass: str, kernel: str) -> list:
    """The opcodes of the innermost loop of ``kernel`` (a substring of its
    mangled name) in ``cuobjdump -sass`` output whose body holds a MUFU
    op: the instructions from a backward branch's target to the branch."""
    ins, mine = [], False
    for line in sass.splitlines():
        if "Function : " in line:
            mine = kernel in line
            continue
        m = SASS_INSTRUCTION.search(line)
        if mine and m:
            op = re.sub(r"^@!?U?P[T0-9]+\s+", "", m.group(2)).split()[0]
            ins.append((int(m.group(1), 16), op, m.group(2)))
    bodies = []
    for addr, op, text in ins:
        target = re.search(r"0x([0-9a-f]+)", text)
        start = int(target.group(1), 16) if target else addr + 1
        if op.startswith("BRA") and start <= addr:
            body = [o for a, o, _ in ins if start <= a <= addr]
            if any(o.startswith("MUFU") for o in body):
                bodies.append(body)
    check(bool(bodies), f"{kernel}: no loop with a MUFU op in its SASS")
    return min(bodies, key=len)


def p2_issue_floor(torch, M, elements: int) -> dict:
    """P2's issue-slot floor from the built kernel's SASS: the instructions
    of its row loop per (row, lane) element (each element has two expf, one
    MUFU.EX2 each; log1pf has none) times the elements, over the SMs' issue
    rate (4 schedulers of 32 lanes, one instruction a cycle each) at the
    card's highest SM clock as nvidia-smi reads it."""
    body = sass_inner_loop(M.cuda_build.sass(M.P.SOURCE),
                           "probe_window_kernel")
    per_body = sum(o == "MUFU.EX2" for o in body) / 2
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm,clocks.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split("\n")[0].split(",")
    max_mhz, now_mhz = (float(c) for c in clocks)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_element = len(body) / per_body
    by_opcode = {}
    for o in body:
        by_opcode[o] = by_opcode.get(o, 0) + 1 / per_body
    return dict(loop_instructions=len(body), elements_per_loop=per_body,
                instructions_per_element=per_element,
                mufu_per_element=sum(v for o, v in by_opcode.items()
                                     if o.startswith("MUFU")),
                opcodes_per_element=dict(sorted(
                    by_opcode.items(), key=lambda kv: -kv[1])),
                elements=elements, sms=sms, sm_clock_max_mhz=max_mhz,
                sm_clock_mhz=now_mhz,
                issue_floor_ms=per_element * elements
                / (sms * 4 * 32 * max_mhz * 1e6) * 1e3)


def rel_l2(torch, got, want) -> float:
    """||got - want|| / ||want||, in float64."""
    got, want = got.double(), want.double()
    den = float(torch.linalg.norm(want))
    diff = float(torch.linalg.norm(got - want))
    return diff / den if den else diff


def gradient_target(np, width: int, height: int):
    """bench.py's synthetic ground truth: a smooth gradient, (H, W, 3)."""
    yy = np.linspace(0.0, 1.0, height, dtype=np.float32)[:, None, None]
    xx = np.linspace(0.0, 1.0, width, dtype=np.float32)[None, :, None]
    return np.broadcast_to(
        np.concatenate([yy + 0 * xx, 0 * yy + xx, 0.5 * (yy + xx)], axis=2),
        (height, width, 3)).copy()


def run_steps(torch, M, phase, step, model, expect, steps, mpix, card,
              after=None):
    """The main path of a training variant: ``steps`` calls of ``step()``
    (one training step, returning its metrics) with every launch count set
    to 0 just before and read just after. Each step must launch each kernel
    of ``expect`` ({symbol: launches}) exactly that often, the loss must
    fall and the parameters stay finite. Emits the phase line (step ms on a
    host clock, mean of steps 2 on; Mpix/s; the fields ``after()`` returns,
    called after the steps; peak memory over the steps) and returns the
    launch totals by symbol and the step ms."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in M.ALL_KERNELS:
        k.launches = 0
    rows, secs = [], []
    for i in range(steps):
        before = {k.symbol: k.launches for k in M.ALL_KERNELS}
        t0 = time.perf_counter()
        metrics = step()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        launched = {k.symbol: k.launches - before[k.symbol]
                    for k in M.ALL_KERNELS}
        loss, psnr = (float(v) for v in torch.stack(
            [metrics["loss"], metrics["psnr"]]).tolist())
        rows.append(dict(step=i + 1, loss=loss, psnr=psnr,
                         launches={n: launched[n] for n in expect},
                         overflowed=bool(metrics["overflowed"]),
                         seconds=secs[-1]))
    launches = {k.symbol: k.launches for k in M.ALL_KERNELS}
    peak = torch.cuda.max_memory_allocated()
    finite = all(bool(torch.isfinite(getattr(model, n)).all())
                 for n in M.PARAM_NAMES)
    step_ms = sum(secs[1:]) / len(secs[1:]) * 1e3
    extra = after() if after else {}
    emit(phase, gaussians=model.capacity, steps=rows,
         launches_in_run=launches, step_ms_mean_2_on=step_ms,
         train_step_mpix_per_s=mpix / (step_ms / 1e3), **extra,
         max_memory_allocated=peak, params_finite=finite, card=card)
    check(all(r["launches"] == expect for r in rows),
          f"{phase}: a step did not launch {expect}: {rows}")
    check(finite and all(math.isfinite(r["loss"]) for r in rows),
          f"{phase}: loss or parameters not finite")
    check(rows[-1]["loss"] < rows[0]["loss"],
          f"{phase}: loss did not fall ({rows[0]['loss']} -> "
          f"{rows[-1]['loss']})")
    return launches, step_ms


def make_step(M, step_fn, model, camera, targets, cfg, tcfg):
    """One training step of ``step_fn`` (``train_step`` or
    ``train_step_batched``) on ``model`` per call, from a fresh Adam and
    densify state kept in ``state``: returns (step, state)."""
    tx = M.T.make_optimizer(tcfg, 10.0)
    state = {"opt": tx.init({n: getattr(model, n) for n in M.PARAM_NAMES}),
             "densify": M.D.DensifyState.zero(model.capacity, "cuda")}

    def step():
        _, state["opt"], state["densify"], metrics = step_fn(
            model, state["opt"], state["densify"], camera, *targets, cfg,
            tcfg, tx)
        return metrics

    return step, state


def train_run(torch, M, scene, model, cam, target, cfg, card, steps=10):
    """The training main path: ``steps`` train_steps of the default
    TrainConfig, each launching J1, B1, B2, B3, G1 and J2 once
    (``run_steps``), then
    one densify + prune pass. Returns the launch totals by kernel and the
    step ms."""
    step, state = make_step(M, M.T.train_step, model, cam,
                            (None, None, target), cfg, M.TrainConfig())
    launches, step_ms = run_steps(
        torch, M, f"train_{scene}", step, model,
        {"rasterize_fwd": 1, "rasterize_bwd": 1, "fused_loss": 1,
         "segment_sums": 1, "project_fwd": 1, "project_bwd": 1}, steps,
        cam.width * cam.height / 1e6, card,
        after=lambda: dict(densify_pass=densify_pass(
            torch, M, model, state["densify"], cam)))
    return ({"B2": launches["rasterize_bwd"], "B3": launches["fused_loss"]},
            step_ms)


def densify_pass(torch, M, model, dstate, cam) -> dict:
    """One densify + prune pass (``Trainer._densify_and_prune``, the
    Trainer's noise and the steps' scene extent 10) after the steps, host
    ms between two synchronisations, on copies of the trained model and its
    densify statistics: as it is (every slot active, so no slot is written)
    and in a pool of twice its capacity, the free half inactive, as a
    Trainer's pool holds it; there also with a gradient threshold of 0,
    every active gaussian a candidate, so that the pass writes its most
    slots (a capacity / 8). The model itself stays as it is for the later
    phases."""
    n = model.capacity
    out = {}
    for label, cap, threshold in (
            ("full_pool", n, M.TrainConfig().densify_grad_threshold),
            ("pool_x2", 2 * n, M.TrainConfig().densify_grad_threshold),
            ("pool_x2_threshold_0", 2 * n, 0.0)):
        with torch.no_grad():
            pad = cap - n
            params = {name: getattr(model, name).detach() for name in
                      M.PARAM_NAMES}
            free = dict(
                means=torch.zeros_like(params["means"][:pad]),
                log_scales=torch.full_like(params["log_scales"][:pad],
                                           math.log(1e-3)),
                quats=params["quats"].new_tensor([1.0, 0.0, 0.0, 0.0])
                .expand(pad, 4),
                opacity_logits=torch.full_like(
                    params["opacity_logits"][:pad], -20.0),
                sh=torch.zeros_like(params["sh"][:pad]))
            pool = M.GaussianModel(
                **{name: torch.cat([params[name], free[name]])
                   for name in M.PARAM_NAMES},
                active=torch.cat([model.active, torch.zeros(
                    pad, dtype=torch.bool, device="cuda")]),
                color_space=model.color_space)
            stats = M.D.DensifyState(
                grad_accum=torch.cat([dstate.grad_accum, torch.zeros(
                    pad, device="cuda")]),
                count=torch.cat([dstate.count, torch.zeros(
                    pad, dtype=torch.int32, device="cuda")]))
        trainer = M.T.Trainer(
            model=pool, cameras=[cam], targets=[None], scene_extent=10.0,
            tcfg=M.TrainConfig(densify_grad_threshold=threshold))
        torch.cuda.synchronize()
        before = int(pool.active.sum())
        t0 = time.perf_counter()
        slots = trainer._densify_and_prune(pool, stats)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        out[label] = dict(capacity=cap, grad_threshold=threshold, host_ms=ms,
                          slots_written=int((slots < cap).sum()),
                          active_before=before,
                          active_after=int(pool.active.sum()))
        del trainer, pool, stats, slots
    return out


def render_grad_run(torch, M, scene, model, cam, target_hwc, cfg, card):
    """The gradient of a ``render_tiled`` image on the card: B1, B5-untile,
    then B5-tile and B2. Counts set to 0 just before, read just after.
    Returns (launch counts, the image's gradient (3, H, W))."""
    for k in M.ALL_KERNELS:
        k.launches = 0
    img = M.R.render_tiled(model, cam, cfg)
    loss = ((img - target_hwc) ** 2).mean()
    params = [getattr(model, n) for n in M.PARAM_NAMES]
    grads = torch.autograd.grad(loss, params + [img])
    torch.cuda.synchronize()
    launches = {k.symbol: k.launches for k in M.ALL_KERNELS}
    finite = all(bool(torch.isfinite(g).all()) for g in grads[:-1])
    emit(f"render_grad_{scene}", launches=launches, finite=finite,
         loss=float(loss.detach()), card=card)
    check(launches["tile_chw"] >= 1 and launches["rasterize_bwd"] >= 1,
          f"render_grad_{scene}: B5-tile or B2 not launched: {launches}")
    check(finite, f"render_grad_{scene}: gradient not finite")
    return launches, grads[-1].permute(2, 0, 1).contiguous()



def train_kernels(torch, M, scene, model, cam, target, g_img, cfg,
                  train_launches, grad_launches, card):
    """B2, B3 and B5-tile against their plain versions on the training
    step's real inputs (the current model's records and render, B3's own
    pixel gradient as B2's cotangent, a render_tiled image's gradient for
    B5-tile): errors, profiler and CUDA-event ms, bounds, plain ms and
    (B5-tile) the library call's ms; and the whole step's gradients from
    two backward passes, bit for bit equal. Returns the three kernel
    rows."""
    R, L, FL = M.R, M.L, M.FL
    h, w, ts, gt = cam.height, cam.width, cfg.tile_size, cfg.group_tiles
    ntx, nty = M.tile_grid(w, h, ts)
    ng = M.num_groups_for(ntx * nty, cfg)
    with torch.no_grad():
        bins = M.bin_gaussians(M.project_gaussians(model, cam, cfg), w, h,
                               cfg)
        args = (bins.pair_records, bins.tile_starts, bins.tile_counts)
        out = R.rasterize_pairs(*args, ng, cfg)
        _, evaluations, pairs_read = R.rasterize_pairs_reference(
            *args, ng, cfg, count_evaluations=True)
        loss_args = (out, target, ntx, nty, ts, h, w, 0.2)
        loss, mse, g_tile = FL._fused_loss_cuda(*loss_args)
        loss_p, mse_p, g_tile_p = FL.fused_photometric_loss_reference(
            *loss_args)
        drec = R._rasterize_bwd_cuda(*args, out, g_tile, ng, cfg)
        drec_again = R._rasterize_bwd_cuda(*args, out, g_tile, ng, cfg)
        drec_p = R.rasterize_pairs_backward_reference(*args, out, g_tile, ng,
                                                      cfg)
        t5 = L.tile_chw_fast(g_img, ng, R.OUT_CHANNELS, gt, ntx, nty, ts)
        t5_p = L.tile_chw(g_img, ng, R.OUT_CHANNELS, gt, ntx, nty, ts)
    # the whole step's gradients, twice: bit for bit equal
    step_grads = [M.T.camera_loss_and_grads(
        model, cam, None, None, target, cfg, M.TrainConfig())[4]
        for _ in range(2)]
    step_repeat = all(torch.equal(step_grads[0][k], step_grads[1][k])
                      for k in step_grads[0])
    del step_grads
    torch.cuda.synchronize()
    num_pairs = int(bins.tile_counts.sum())
    b2_err = {row: rel_l2(torch, drec[row], drec_p[row])
              for row in M.GRAD_ROWS}
    b2_zero = (not drec[[6, 7, 8, 9, 10, 15]].any()
               and not drec[:, num_pairs:].any())
    b2_repeat = torch.equal(drec, drec_again)
    b3_loss_err = abs(float(loss) - float(loss_p)) / abs(float(loss_p))
    b3_mse_err = abs(float(mse) - float(mse_p)) / abs(float(mse_p))
    b3_grad_err = rel_l2(torch, g_tile, g_tile_p)
    b5_equal = torch.equal(t5, t5_p)

    b2_times = profiled(M, lambda: R._rasterize_bwd_cuda(
        *args, out, g_tile, ng, cfg), ("rasterize_bwd_kernel",
                                       "zero_tail_kernel"))
    b2_plain_ms = M.U.cuda_ms(lambda: R.rasterize_pairs_backward_reference(
        *args, out, g_tile, ng, cfg), iters=1, warmup=0)
    b3_times = profiled(M, lambda: FL._fused_loss_cuda(*loss_args),
                        ("fused_loss_kernel", "sum_partials_kernel"))
    b3_plain_ms = M.U.cuda_ms(
        lambda: FL.fused_photometric_loss_reference(*loss_args),
        iters=2)
    b5_plain_ms = M.U.cuda_ms(lambda: L.tile_chw(
        g_img, ng, R.OUT_CHANNELS, gt, ntx, nty, ts), iters=5)
    # the library yardstick: the image-row -> tile transposition as one
    # permute + contiguous of the image padded to whole tiles (it writes
    # neither the zero channels nor the group padding)
    padded = torch.nn.functional.pad(g_img, (0, ntx * ts - w, 0,
                                             nty * ts - h))
    b5_times = in_turns(
        M, lambda: L.tile_chw_fast(g_img, ng, R.OUT_CHANNELS, gt, ntx, nty,
                                   ts),
        lambda: padded.reshape(3, nty, ts, ntx, ts).permute(
            0, 1, 3, 2, 4).contiguous())
    del padded

    work = dict(evaluations=evaluations, pairs_read=pairs_read,
                pairs=num_pairs,
                nonempty_tiles=int((bins.tile_counts > 0).sum()))
    b2_bound, b2_by = bound_of(M, *M.K.b2(work, ntx * nty, ts))
    b3_bound, b3_by = bound_of(M, *M.K.b3(w, h))
    # B5-tile (no count in gsbench/counts.py): the image read, the
    # (groups, 5, ...) tiles written
    b5_bytes = 3 * h * w * 4 + out.numel() * 4
    b5_bound, b5_by = bound_of(M, b5_bytes, 0)
    reason = ("no single PyTorch call computes this function; its plain "
              "version is a composition of many")
    rows = [
        dict(name="B2 rasterize_bwd", route="cuda",
             source=f"{PACKAGE}/csrc/rasterize_bwd.cu", replaces=B2_REPLACES,
             launches=train_launches["B2"], max_abs_err=float(
                 (drec - drec_p).abs().max()),
             **b2_times, plain_ms=b2_plain_ms, bound_ms=b2_bound,
             bound_by=b2_by, library_ms=None),
        dict(name="B3 fused_loss", route="cuda",
             source=f"{PACKAGE}/csrc/fused_loss.cu", replaces=B3_REPLACES,
             launches=train_launches["B3"], max_abs_err=float(
                 (g_tile - g_tile_p).abs().max()),
             **b3_times, plain_ms=b3_plain_ms, bound_ms=b3_bound,
             bound_by=b3_by, library_ms=None),
        b5_row(b5_times, b5_bytes, 2 * 3 * ntx * nty * ts * ts * 4,
               name="B5-tile tile_chw", route="cuda",
               source=f"{PACKAGE}/csrc/tile_chw.cu",
               replaces=B5_TILE_REPLACES,
               launches=grad_launches["tile_chw"],
               max_abs_err=float((t5 - t5_p).abs().max()),
               plain_ms=b5_plain_ms, bound_ms=b5_bound, bound_by=b5_by),
    ]
    emit(f"train_kernels_{scene}", kernels=rows, num_pairs=num_pairs,
         b2_rel_l2_per_row=b2_err, b2_exact_zeros=b2_zero,
         b2_bit_equal_on_repeat=b2_repeat, b2_work=work,
         b3_loss=float(loss), b3_loss_rel_err=b3_loss_err,
         b3_mse_rel_err=b3_mse_err, b3_grad_rel_l2=b3_grad_err,
         b5_tile_exactly_equal=b5_equal,
         step_gradients_bit_equal_on_repeat=step_repeat,
         library_ms_null_reason={"B2": reason, "B3": reason},
         tolerance=("B2 relative L2 1e-4 per record row; B3 value and MSE "
                    "rel 1e-5, gradient relative L2 1e-4; B5-tile exact"),
         card=card)
    check(max(b2_err.values()) <= 1e-4 and b2_zero and b2_repeat,
          f"{scene}: B2 disagrees with its plain version: {b2_err}, zeros "
          f"{b2_zero}, repeat {b2_repeat}")
    check(b3_loss_err <= 1e-5 and b3_mse_err <= 1e-5
          and b3_grad_err <= 1e-4,
          f"{scene}: B3 disagrees with its plain version: loss "
          f"{b3_loss_err}, mse {b3_mse_err}, grad {b3_grad_err}")
    check(b5_equal, f"{scene}: B5-tile differs from its plain version")
    check(step_repeat, f"{scene}: two backward passes of a step differ")
    return rows


def g1_kernel(torch, M, shape, model, cam, cfg, card):
    """G1, the gather's backward, at a benchmark cell's shape (``shape``
    names it): ``model`` binned under ``cfg`` with the projection's
    gradient fields as leaves, a seeded cotangent in every row and slot
    (G1 reads only the gradient rows of the emitted slots). G1 against
    its plain version (the library chain it replaced; relative L2 1e-5),
    both against the float64 block sums (G1 no further off than the plain
    version, or within 1e-6), exact zeros outside the gradient rows and
    for gaussians with no pairs, bit for bit on repeat, each depth rank's
    sums in its gaussian's column (bit for bit those written by rank given
    the identity order), one launch per call; profiler and CUDA-event ms
    (each of its kernels apart), its bound (bytes: the 10 gradient rows and
    perm of each emitted slot read, order, lo and hi read and 16 floats
    written per gaussian) and the plain chain's ms. Returns its kernel
    row."""
    B = M.B
    with torch.no_grad():
        proj = M.project_gaussians(model, cam, cfg)
    leaves = {f: getattr(proj, f).requires_grad_(True)
              for f in ("mean2d", "conic", "opacity", "color", "depth")}
    bins = M.bin_gaussians(dataclasses.replace(proj, **leaves), cam.width,
                           cam.height, cfg)
    node = bins.pair_records.grad_fn   # the gather's: order, perm, lo, hi
    order, perm, lo, hi = node.saved_tensors
    total, n, mp = node.total_emit, lo.shape[0], perm.shape[0]
    del bins, proj, leaves
    gen = torch.Generator(device="cuda").manual_seed(19)
    g = torch.randn((16, mp), generator=gen, device="cuda")
    args = (g, order, perm, lo, hi)
    before = B.SEGMENT_SUMS.launches
    d = B.gather_pairs_backward(*args, total)
    again = B.gather_pairs_backward(*args, total)
    launched = B.SEGMENT_SUMS.launches - before
    by_rank = B.gather_pairs_backward(
        g, torch.arange(n, device="cuda"), perm, lo, hi, total)
    through_order = torch.equal(d[:, order], by_rank)
    del by_rank
    plain = B.gather_pairs_backward_reference(*args)
    rows = list(M.GRAD_ROWS)
    inv = torch.empty(total, dtype=torch.int64, device="cuda")
    inv[perm[:total]] = torch.arange(total, device="cuda")
    cum = torch.nn.functional.pad(
        torch.cumsum(g[rows][:, inv].double(), dim=1), (1, 0))
    exact = torch.empty((len(rows), n), dtype=torch.float64, device="cuda")
    exact[:, order] = cum[:, hi] - cum[:, lo]
    del inv, cum
    torch.cuda.synchronize()
    others = [r for r in range(16) if r not in M.GRAD_ROWS]
    empty = lo == hi
    err = rel_l2(torch, d[rows], exact)
    plain_err = rel_l2(torch, plain[rows], exact)
    vs_plain = rel_l2(torch, d, plain)
    zeros = not d[others].any() and not d[:, order[empty]].any()
    repeat = torch.equal(d, again)
    del exact, again
    times = profiled(M, lambda: B.gather_pairs_backward(*args, total),
                     ("segment_sums_kernel", "to_emission_kernel",
                      "blocks_by_gaussian_kernel"))
    plain_ms = M.U.cuda_ms(lambda: B.gather_pairs_backward_reference(*args),
                           iters=3)
    nbytes = 48 * total + 88 * n
    bound, by = bound_of(M, nbytes, 0)
    pairs = (hi - lo)[~empty]
    row = dict(name=f"G1 segment_sums {shape}", route="cuda",
               source=f"{PACKAGE}/csrc/segment_sums.cu",
               # no Pallas kernel: the JAX package's gather transpose is
               # XLA ops
               replaces=None, launches=launched,
               max_abs_err=float((d - plain).abs().max()), **times,
               plain_ms=plain_ms, bound_ms=bound, bound_by=by,
               library_ms=None)
    emit("g1_kernel", shape=shape, kernels=[row], gaussians=n,
         pool_slots=mp,
         emitted_pairs=total, bytes=nbytes,
         pairs_per_gaussian=dict(mean=float(pairs.double().mean()),
                                 max=int(pairs.max())),
         gaussians_with_pairs=int(pairs.numel()),
         rel_l2_vs_float64=err, plain_rel_l2_vs_float64=plain_err,
         rel_l2_vs_plain=vs_plain, exact_zeros=zeros,
         bit_equal_on_repeat=repeat, by_rank_through_order=through_order,
         library_ms_null_reason="no single PyTorch call computes this "
                                "function; its plain version is a "
                                "composition of many",
         tolerance="relative L2 1e-5 against the plain version; no further "
                   "than it from the float64 sums, or within 1e-6",
         card=card)
    check(vs_plain <= 1e-5 and err <= max(plain_err, 1e-6),
          f"g1_kernel {shape}: G1 disagrees: {vs_plain} against the plain version, "
          f"{err} against the float64 sums (plain {plain_err})")
    check(zeros and repeat and through_order and launched == 2,
          f"g1_kernel {shape}: zeros {zeros}, repeat {repeat}, through the order "
          f"{through_order}, launches {launched}")
    return row


def scene_30k(M, seed=3_000_000_019):
    """(model, camera) of the treehill_3dgs_30k configuration on the card:
    its 3.1M gaussians from its scene recipe at ``seed`` and its first
    ring camera at 1267x831."""
    cfg = json.loads(
        (REPO / "gsbench/configs/treehill_3dgs_30k.json").read_text())
    gen = M.GS.generator(seed, "cuda")
    xyz, rgb = M.GS.point_cloud(cfg, gen, "cuda")
    params, active = M.GS.initial_params(cfg, xyz, rgb, xyz.shape[0], gen,
                                         sh_rest_std=0.1)
    w, h = cfg["width"], cfg["height"]
    focal = cfg["focal_per_width"] * w
    r, t = M.GS.ring_poses(cfg, 1, seed)[0]
    cam = M.make_camera(focal, focal, w, h, M.GS.quaternion(r), t,
                        device="cuda")
    return M.GaussianModel(**params, active=active, color_space="sh"), cam


def ulps(torch, got, want) -> int:
    """The largest distance between two float32 tensors in units in the
    last place (0 and -0 alike)."""
    def ordered(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((ordered(got) - ordered(want)).abs().max())


def projection_kernels(torch, M, xyz, rgb, cam, card):
    """J1 and J2 at both benchmark cells' shapes: the 52,363 points with
    SH 3 (the render cell) and the same in a pool of 4x (the train cell),
    the points with seeded rotations, per-axis scales and higher SH
    coefficients. J1 against the plain version on the card (radius and
    valid equal, each float field's ulps), J2 against autograd through the
    plain version on seeded cotangents (relative L2 1e-5 per leaf, exact
    zeros where autograd has them, bit for bit on repeat), one launch
    each per call; profiler and CUDA-event ms, the bound (bytes: J1 reads
    237 B and writes 45 B a slot, J2 reads the inputs and 40 B of
    cotangents and writes 236 B) and the plain chain's ms (forward; its
    autograd backward). Returns the kernel rows of the train shape."""
    P = M.J
    fields = ("mean2d", "depth", "conic", "color", "opacity")
    gen = torch.Generator(device="cuda").manual_seed(21)
    n = len(xyz)
    rows = {}
    for shape, capacity in (("render", n), ("train", 4 * n)):
        model = M.init_from_points(xyz, rgb, sh_degree=3, color_space="sh",
                                   scale_init=None, opacity=0.9,
                                   capacity=capacity, device="cuda")
        with torch.no_grad():
            model.sh[:n, 1:] = 0.1 * torch.randn(
                (n, 15, 3), generator=gen, device="cuda")
            model.log_scales[:n] += 0.5 * torch.randn(
                (n, 3), generator=gen, device="cuda")
            model.quats[:n] = torch.randn((n, 4), generator=gen,
                                          device="cuda")
        leaves = [getattr(model, k) for k in M.PARAM_NAMES]
        before = (P.PROJECT_FWD.launches, P.PROJECT_BWD.launches)
        with torch.no_grad():
            got = P.project_gaussians(model, cam)
            want = P.project_gaussians_reference(model, cam)
        field_ulps = {f: ulps(torch, getattr(got, f), getattr(want, f))
                      for f in fields}
        radius_equal = torch.equal(got.radius, want.radius)
        valid_equal = torch.equal(got.valid, want.valid)
        cot = {f: torch.randn(getattr(want, f).shape, generator=gen,
                              device="cuda") for f in fields}
        plain = P.project_gaussians_reference(model, cam)
        outs = [getattr(plain, f) for f in fields]
        cots = [cot[f] for f in fields]
        want_g = torch.autograd.grad(outs, leaves, cots, retain_graph=True)
        grads = []
        for _ in range(2):
            proj = P.project_gaussians(model, cam)
            grads.append(torch.autograd.grad(
                [getattr(proj, f) for f in fields], leaves, cots))
        fwd_launched = P.PROJECT_FWD.launches - before[0]
        bwd_launched = P.PROJECT_BWD.launches - before[1]
        rel = {k: rel_l2(torch, g, w)
               for k, g, w in zip(M.PARAM_NAMES, grads[0], want_g)}
        zeros = all(not bool(g[w == 0].any())
                    for g, w in zip(grads[0], want_g))
        repeat = all(torch.equal(a, b) for a, b in zip(*grads))
        params = [getattr(model, k).detach() for k in M.PARAM_NAMES]
        degree = 3
        with torch.no_grad():
            j1 = profiled(M, lambda: P.project_gaussians(model, cam),
                          ("project_fwd_kernel",))
            j1_plain_ms = M.U.cuda_ms(
                lambda: P.project_gaussians_reference(model, cam), iters=5)
        j2 = profiled(M, lambda: P._project_bwd_cuda(
            params, cam, M.RasterizerConfig(), degree, cots),
            ("project_bwd_kernel",))
        j2_plain_ms = M.U.cuda_ms(lambda: torch.autograd.grad(
            outs, leaves, cots, retain_graph=True), iters=5)
        torch.cuda.synchronize()
        active = int(model.active.sum())
        fwd_ops = M.K.projection_ops(capacity, 3)
        for name, t, plain_ms, nbytes, ops, launched in (
                ("J1 project_fwd", j1, j1_plain_ms, 282 * capacity, fwd_ops,
                 fwd_launched),
                ("J2 project_bwd", j2, j2_plain_ms, 513 * capacity,
                 fwd_ops * M.K.PROJECTION_BACKWARD_FACTOR, bwd_launched)):
            bound, by = bound_of(M, nbytes, ops)
            rows.setdefault(shape, []).append(dict(
                name=name, route="cuda",
                source=f"{PACKAGE}/csrc/projection.cu",
                # no Pallas kernel: the JAX package's projection is XLA ops
                replaces=None, launches=launched, **t, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, bytes=nbytes,
                library_ms=None))
        emit(f"projection_kernels_{shape}", kernels=rows[shape],
             slots=capacity, active=active, field_ulps=field_ulps,
             radius_equal=radius_equal, valid_equal=valid_equal,
             grad_rel_l2=rel, exact_zeros=zeros, bit_equal_on_repeat=repeat,
             library_ms_null_reason="no single PyTorch call computes this "
                                    "function; its plain version is a "
                                    "composition of many",
             tolerance="J1: every field bit-equal; J2: relative L2 1e-5 "
                       "against autograd, its exact zeros",
             card=card)
        check(radius_equal and valid_equal and not any(field_ulps.values()),
              f"projection_kernels_{shape}: J1 differs: ulps {field_ulps}, "
              f"radius {radius_equal}, valid {valid_equal}")
        check(max(rel.values()) <= 1e-5 and zeros and repeat,
              f"projection_kernels_{shape}: J2 differs: {rel}, zeros "
              f"{zeros}, repeat {repeat}")
        check(fwd_launched == 3 and bwd_launched == 2,
              f"projection_kernels_{shape}: launches J1 {fwd_launched}, "
              f"J2 {bwd_launched}")
        del model, leaves, got, want, plain, outs, want_g, grads, params
        torch.cuda.empty_cache()
    return rows["train"]


def ssim_kernels(torch, M, height, width, card):
    """B4a, B4b (both grad_target settings) and B4c against their plain
    versions on seeded (3, H, W) images of the training path's size: the
    value (rel 1e-5), the gradients (relative L2 1e-4), the target's
    gradient exactly 0 without grad_target, each bit for bit equal on
    repeat, and B4c (both grad_target settings) against B4a and B4b (value
    rel 1e-6, gradient relative L2 1e-5; bit-equality reported). Then the
    one-pass path, ``1 - fused_ssim(precompute_grad=
    True)`` under autograd, with the launch counts set to 0 just before and
    read just after: it must launch B4c once and B4a, B4b never. Profiler
    and CUDA-event times (the grad_target instances of B4b and B4c timed
    too), bounds, plain times. Returns the three kernel
    rows, B4a's and B4b's launches left for the split training run to fill
    in."""
    S = M.S
    c1, c2 = S.L.C1, S.L.C2
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.rand((3, height, width), generator=gen, device="cuda")
    b = (a + 0.2 * torch.randn((3, height, width), generator=gen,
                               device="cuda")).clamp(0.0, 1.0)
    g = torch.tensor(0.7, device="cuda")
    one = torch.ones((), device="cuda")
    with torch.no_grad():
        value = S._ssim_sum_cuda(a, b, c1, c2)
        a_repeat = torch.equal(value, S._ssim_sum_cuda(a, b, c1, c2))
        value_p = S.ssim_sum_reference(a, b, c1, c2)
    a_err = abs(float(value) - float(value_p)) / abs(float(value_p))
    b_err, b_repeat, b_max = {}, {}, 0.0
    for gt in (False, True):
        dx, dy = S._ssim_grad_cuda(a, b, g, c1, c2, gt)
        again = S._ssim_grad_cuda(a, b, g, c1, c2, gt)
        dxp, dyp = S.ssim_grad_reference(a, b, g, c1, c2, gt)
        b_err[f"grad_target={gt}"] = [rel_l2(torch, dx, dxp)] + (
            [rel_l2(torch, dy, dyp)] if gt else [])
        b_repeat[f"grad_target={gt}"] = torch.equal(dx, again[0]) and (
            not gt or torch.equal(dy, again[1]))
        if not gt:
            b_max = float((dx - dxp).abs().max())
        del dx, dy, again, dxp, dyp
    v_c, ux, _ = S._ssim_value_grad_cuda(a, b, c1, c2, False)
    c_repeat = torch.equal(ux, S._ssim_value_grad_cuda(a, b, c1, c2,
                                                       False)[1])
    ux_b, _ = S._ssim_grad_cuda(a, b, one, c1, c2, False)
    _, uxp, _ = S.ssim_value_grad_reference(a, b, c1, c2, False)
    c_value_err = abs(float(v_c) - float(value)) / abs(float(value))
    c_grad_err = rel_l2(torch, ux, ux_b)
    c_plain_err = rel_l2(torch, ux, uxp)
    c_max = float((ux - uxp).abs().max())
    c_bit_equal = dict(value_to_b4a=torch.equal(v_c, value),
                       grad_to_b4b=torch.equal(ux, ux_b))
    del ux, ux_b, uxp
    # the grad_target instance of B4c, gated as the other: against B4a's
    # value and B4b's two gradients at unit cotangent, and on repeat
    v_t, ux, uy = S._ssim_value_grad_cuda(a, b, c1, c2, True)
    again = S._ssim_value_grad_cuda(a, b, c1, c2, True)
    ux_b, uy_b = S._ssim_grad_cuda(a, b, one, c1, c2, True)
    ct_value_err = abs(float(v_t) - float(value)) / abs(float(value))
    ct_grad_err = [rel_l2(torch, ux, ux_b), rel_l2(torch, uy, uy_b)]
    ct_repeat = all(torch.equal(p, q) for p, q in zip((v_t, ux, uy), again))
    ct_value_to_b4a = torch.equal(v_t, value)
    del ux, uy, again, ux_b, uy_b

    # the one-pass path through the entry point
    x = a.clone().requires_grad_(True)
    y = b.clone().requires_grad_(True)
    torch.cuda.synchronize()
    for k in M.ALL_KERNELS:
        k.launches = 0
    dx_path, dy_path = torch.autograd.grad(
        1.0 - S.fused_ssim(x, y, grad_target=False, precompute_grad=True),
        [x, y])
    torch.cuda.synchronize()
    vg_launches = {k.symbol: k.launches for k in M.ALL_KERNELS}
    target_zero = not dy_path.any()
    del x, y, dx_path, dy_path

    b4a_times = profiled(M, lambda: S._ssim_sum_cuda(a, b, c1, c2),
                         ("ssim_sum_kernel", "sum_partials_kernel"))
    b4b_times = profiled(M, lambda: S._ssim_grad_cuda(a, b, g, c1, c2, False),
                         ("ssim_grad_kernel",))
    b4b_target = profiled(M, lambda: S._ssim_grad_cuda(
        a, b, g, c1, c2, True), ("ssim_grad_kernel",))
    b4c_times = profiled(M, lambda: S._ssim_value_grad_cuda(
        a, b, c1, c2, False), ("ssim_grad_kernel", "sum_partials_kernel"))
    b4c_target = profiled(M, lambda: S._ssim_value_grad_cuda(
        a, b, c1, c2, True), ("ssim_grad_kernel", "sum_partials_kernel"))
    with torch.no_grad():
        b4a_plain_ms = M.U.cuda_ms(lambda: S.ssim_sum_reference(
            a, b, c1, c2), iters=3)
    b4b_plain_ms = M.U.cuda_ms(lambda: S.ssim_grad_reference(
        a, b, g, c1, c2, False), iters=2)
    b4c_plain_ms = M.U.cuda_ms(lambda: S.ssim_value_grad_reference(
        a, b, c1, c2, False), iters=2)
    px = 3 * height * width
    # B4a reads the two images; B4b and B4c read them and write the
    # prediction's gradient
    b4a_bound, b4a_by = bound_of(M, 2 * px * 4, B4A_OPS_PER_PIXEL * px)
    b4b_bound, b4b_by = bound_of(M, 3 * px * 4, B4B_OPS_PER_PIXEL * px)
    b4c_bound, b4c_by = bound_of(M, 3 * px * 4, B4C_OPS_PER_PIXEL * px)
    rows = [
        dict(name="B4a ssim_sum", route="cuda",
             source=f"{PACKAGE}/csrc/ssim.cu", replaces=B4A_REPLACES,
             launches=None, max_abs_err=abs(float(value) - float(value_p)),
             **b4a_times, plain_ms=b4a_plain_ms, bound_ms=b4a_bound,
             bound_by=b4a_by, library_ms=None),
        dict(name="B4b ssim_grad", route="cuda",
             source=f"{PACKAGE}/csrc/ssim.cu", replaces=B4B_REPLACES,
             launches=None, max_abs_err=b_max, **b4b_times,
             plain_ms=b4b_plain_ms, bound_ms=b4b_bound, bound_by=b4b_by,
             library_ms=None),
        dict(name="B4c ssim_value_grad", route="cuda",
             source=f"{PACKAGE}/csrc/ssim.cu", replaces=B4C_REPLACES,
             launches=vg_launches["ssim_value_grad"], max_abs_err=c_max,
             **b4c_times, plain_ms=b4c_plain_ms, bound_ms=b4c_bound,
             bound_by=b4c_by, library_ms=None),
    ]
    emit("ssim_kernels", shape=[3, height, width], kernels=rows,
         b4a_value_rel_err=a_err, b4a_bit_equal_on_repeat=a_repeat,
         b4b_grad_rel_l2=b_err, b4b_bit_equal_on_repeat=b_repeat,
         b4b_grad_target_times=b4b_target,
         b4c_value_rel_err_vs_b4a=c_value_err,
         b4c_grad_rel_l2_vs_b4b=c_grad_err,
         b4c_grad_rel_l2_vs_plain=c_plain_err,
         b4c_bit_equal_on_repeat=c_repeat, b4c_bit_equal=c_bit_equal,
         b4c_grad_target_times=b4c_target,
         b4c_grad_target_value_rel_err_vs_b4a=ct_value_err,
         b4c_grad_target_grad_rel_l2_vs_b4b=ct_grad_err,
         b4c_grad_target_bit_equal_on_repeat=ct_repeat,
         b4c_grad_target_value_bit_equal_to_b4a=ct_value_to_b4a,
         one_pass_path_launches=vg_launches,
         target_grad_exactly_zero=target_zero,
         gradient_shape="(3, H, W): no storage outside the image",
         library_ms_null_reason="no single PyTorch call computes SSIM",
         tolerance=("B4a value rel 1e-5; B4b gradient relative L2 1e-4; "
                    "B4c vs B4a value rel 1e-6 and bit-equal, vs B4b "
                    "gradient relative L2 1e-5, both grad_target "
                    "settings; bit-equal on repeat"),
         card=card)
    check(a_err <= 1e-5 and a_repeat,
          f"B4a disagrees with its plain version: {a_err}, {a_repeat}")
    check(max(e for v in b_err.values() for e in v) <= 1e-4
          and all(b_repeat.values()),
          f"B4b disagrees with its plain version: {b_err}, {b_repeat}")
    check(c_value_err <= 1e-6 and c_grad_err <= 1e-5 and c_plain_err <= 1e-4
          and c_repeat,
          f"B4c disagrees with B4a/B4b or its plain version: {c_value_err}, "
          f"{c_grad_err}, {c_plain_err}, {c_repeat}")
    check(ct_value_err <= 1e-6 and max(ct_grad_err) <= 1e-5 and ct_repeat,
          f"B4c (grad_target) disagrees with B4a/B4b: {ct_value_err}, "
          f"{ct_grad_err}, {ct_repeat}")
    # B4a and B4c add the same windows in the same order
    check(c_bit_equal["value_to_b4a"] and ct_value_to_b4a,
          f"B4a's value is not B4c's bit for bit: {c_bit_equal}, "
          f"grad_target {ct_value_to_b4a}")
    check(vg_launches["ssim_value_grad"] == 1
          and vg_launches["ssim_sum"] == vg_launches["ssim_grad"] == 0,
          f"one-pass SSIM path: {vg_launches}")
    check(target_zero, "SSIM: the target's gradient is not 0")
    return rows


def probes(torch, np, M, card):
    """P1 and P2 at the probe script's size (65,856 programs, a 2^18 x 128
    table): the main path is the port's probe script, ``probe1()`` and
    ``probe2()`` (torch.profiler device times), with every launch count set
    to 0 just before and read just after. Then P1 into a NaN-filled buffer
    exactly equal to zeros, and P2 against its plain version on the
    script's inputs and on seeded random ones (relative L2 1e-6), bit-equal
    on repeat; CUDA-event times, ns per program, bounds, P2's issue-slot
    floor from its SASS, plain times and P1's library call
    (``torch.empty(...).zero_()``). Returns the two kernel rows."""
    P, PK, U = M.P, M.PK, M.U
    nt, out_shape = P.NT, (P.NT, P.OUT_ROWS, P.PIX)
    torch.cuda.synchronize()
    for k in M.ALL_KERNELS:
        k.launches = 0
    durs = {"P1": PK.probe1(), "P2": PK.probe2()}
    torch.cuda.synchronize()
    launches = {k.symbol: k.launches for k in M.ALL_KERNELS}

    buf = torch.full(out_shape, float("nan"), device="cuda")
    P._probe_zero_cuda(buf)
    p1_err = float(buf.abs().max())
    p1_equal = torch.equal(buf, P.probe_zero_reference(nt, "cuda"))
    del buf
    inputs = {"script": P.probe_inputs(nt, P.MP, device="cuda"),
              "seeded_random": P.probe_random_inputs(nt, P.MP, seed=0,
                                                     device="cuda")}
    p2 = {}
    for name, args in inputs.items():
        got = P.probe_window(*args)
        again = P.probe_window(*args)
        want = P.probe_window_reference(*args, batch=8192)
        p2[name] = dict(rel_l2=rel_l2(torch, got, want),
                        max_abs_err=float((got - want).abs().max()),
                        bit_equal_on_repeat=torch.equal(got, again),
                        programs_by_chunks=torch.bincount(
                            P.window_chunks(*args[:2])[1]).tolist(),
                        mean=float(want.mean()))
        del got, again, want

    args = inputs["script"]
    p1_ms = U.cuda_ms(lambda: P.probe_zero(nt, "cuda"), iters=20)
    p1_plain_ms = U.cuda_ms(lambda: P.probe_zero_reference(nt, "cuda"),
                            iters=20)
    p1_lib_ms = U.cuda_ms(lambda: torch.empty(out_shape,
                                              device="cuda").zero_(),
                          iters=20)
    p2_ms = U.cuda_ms(lambda: P.probe_window(*args), iters=20)
    p2_random_ms = U.cuda_ms(lambda: P.probe_window(
        *inputs["seeded_random"]), iters=20)
    p2_plain_ms = U.cuda_ms(lambda: P.probe_window_reference(
        *args, batch=8192), iters=2)

    # P1 writes its output; P2 writes it and reads the starts, the counts
    # and every table row that some window covers, once, and does
    # P2_OPS_PER_ELEMENT per window row and lane of each chunk
    out_bytes = 4 * nt * P.OUT_ROWS * P.PIX
    astart, nchunks = (t.cpu().numpy() for t in P.window_chunks(*args[:2]))
    cover = np.zeros(P.MP + 1, np.int64)
    live = nchunks > 0
    np.add.at(cover, np.minimum(astart[live], P.MP), 1)
    np.add.at(cover, np.minimum(astart[live] + P.G * nchunks[live], P.MP),
              -1)
    rows_read = int((np.cumsum(cover)[:P.MP] > 0).sum())
    p1_bound, p1_by = bound_of(M, out_bytes, 0)
    elements = P.G * P.PIX * int(nchunks.sum())
    p2_bound, p2_by = bound_of(
        M, out_bytes + 8 * nt + 4 * P.REC_COLS * rows_read,
        P.P2_OPS_PER_ELEMENT * elements)
    p2_sass = p2_issue_floor(torch, M, elements)
    source = f"{PACKAGE}/csrc/probe.cu"
    rows = [
        dict(name="P1 probe_zero", route="cuda", source=source,
             replaces=P1_REPLACES, launches=launches["probe_zero"],
             max_abs_err=p1_err, ms=p1_ms, plain_ms=p1_plain_ms,
             bound_ms=p1_bound, bound_by=p1_by, library_ms=p1_lib_ms),
        dict(name="P2 probe_window", route="cuda", source=source,
             replaces=P2_REPLACES, launches=launches["probe_window"],
             max_abs_err=p2["script"]["max_abs_err"], ms=p2_ms,
             plain_ms=p2_plain_ms, bound_ms=p2_bound, bound_by=p2_by,
             issue_floor_ms=p2_sass["issue_floor_ms"], library_ms=None),
    ]
    emit("probes", programs=nt, kernels=rows, launches_in_run=launches,
         profiler_ms={k: [d * 1e3 for d in v] for k, v in durs.items()},
         ns_per_program={"P1": p1_ms * 1e6 / nt, "P2": p2_ms * 1e6 / nt,
                         "P2_seeded_random": p2_random_ms * 1e6 / nt},
         p2_seeded_random_ms=p2_random_ms, p1_exactly_zero=p1_equal, p2=p2,
         p2_table_rows_read=rows_read, p2_sass=p2_sass,
         library_ms_null_reason={
             "P2": "no single PyTorch call computes this function"},
         tolerance="P1 exact; P2 relative L2 1e-6", card=card)
    check(p1_equal, "P1 did not write zeros over its whole output")
    check(all(v["rel_l2"] <= 1e-6 and v["bit_equal_on_repeat"]
              for v in p2.values()),
          f"P2 disagrees with its plain version: {p2}")
    # torch.profiler can miss one of the three launches when an earlier
    # profiling session ran in the process; the CUDA-event times above are
    # the row's
    check(all(1 <= len(v) <= 3 for v in durs.values()),
          f"the profiler did not time the probes: {durs}")
    check(launches["probe_zero"] >= 1 and launches["probe_window"] >= 1,
          f"probes: a kernel was not launched: {launches}")
    return rows


def checkpoint_run(torch, M, xyz, rgb, cam, target_hwc, tmp, card):
    """Checkpoint and resume at the ref_init scene: ten ``Trainer`` steps
    with ``checkpoint_every=5`` (steps 5 and 10 kept), then a fresh Trainer
    that resumes from step 5 with ``checkpoint_keep=1`` and runs to step
    10. Its parameters, Adam moments and step must equal the straight
    run's bit for bit; its step-10 save must replace the straight run's and
    leave only step 10. Save and load ms (host clock, the card
    synchronised), bytes on disk, launches. Returns the trained model."""
    C, T = M.C, M.T
    ckpt = os.path.join(tmp, "ckpt")
    tcfg = M.TrainConfig(iterations=10, checkpoint_every=5,
                         checkpoint_keep=2)

    def trainer(keep):
        return T.Trainer(
            model=M.init_from_points(xyz, rgb, device="cuda"),
            cameras=[cam], targets=[target_hwc], scene_extent=10.0,
            tcfg=dataclasses.replace(tcfg, checkpoint_keep=keep),
            log_every=5, checkpoint_dir=ckpt)

    torch.cuda.synchronize()
    for k in M.ALL_KERNELS:
        k.launches = 0
    straight = trainer(2)
    history = straight.run(10)
    torch.cuda.synchronize()
    launches = {k.symbol: k.launches for k in M.ALL_KERNELS}
    kept_straight = C.list_checkpoint_steps(ckpt)
    resumed = trainer(1)
    restored = resumed.resume(ckpt, step=5)
    resumed_history = resumed.run(5)
    torch.cuda.synchronize()
    kept_resumed = C.list_checkpoint_steps(ckpt)

    params_equal = {n: torch.equal(getattr(straight.model, n),
                                   getattr(resumed.model, n))
                    for n in M.PARAM_NAMES}
    params_equal["active"] = torch.equal(straight.model.active,
                                         resumed.model.active)
    moments_equal = {}
    for n in M.PARAM_NAMES:
        a, b = straight.opt_state[n], resumed.opt_state[n]
        moments_equal[n] = all(
            (x is None and y is None) or (x is not None and y is not None
                                          and torch.equal(x, y))
            for x, y in ((a.count, b.count), (a.mu, b.mu), (a.nu, b.nu),
                         (a.schedule_count, b.schedule_count)))

    timing = os.path.join(tmp, "timing")
    save_ms, load_ms = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        C.save_checkpoint(timing, straight.model, straight.opt_state, 10)
        save_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        C.load_checkpoint(timing, resumed.model, resumed.opt_state)
        torch.cuda.synchronize()
        load_ms.append((time.perf_counter() - t0) * 1e3)
    state_bytes = os.path.getsize(os.path.join(timing, "step_10",
                                               C.STATE_FILE))
    emit("checkpoint_ref_init", gaussians=straight.model.capacity,
         history=history, resumed_history=resumed_history,
         restored_step=restored, steps=[straight.step, resumed.step],
         launches_in_straight_run=launches,
         kept_after_straight_run=kept_straight,
         kept_after_resumed_run=kept_resumed,
         params_bit_equal=params_equal, adam_bit_equal=moments_equal,
         save_ms=save_ms, load_ms=load_ms, state_bytes=state_bytes,
         card=card)
    check(restored == 5 and straight.step == resumed.step == 10,
          "checkpoint_ref_init: wrong steps")
    check(all(params_equal.values()) and all(moments_equal.values()),
          f"checkpoint_ref_init: the resumed run differs from the straight "
          f"one: {params_equal}, {moments_equal}")
    check(kept_straight == [5, 10] and kept_resumed == [10],
          f"checkpoint_ref_init: retention {kept_straight}, {kept_resumed}")
    check(all(launches[k] == 10 for k in ("rasterize_fwd", "rasterize_bwd",
                                          "fused_loss")),
          f"checkpoint_ref_init: launches {launches}")
    return straight.model


def eval_run(torch, M, model, cams, targets, tmp, card):
    """``evaluate`` on the ring cameras at 5068x3324, each view launching B1
    and B5-untile once (counts set to 0 just before, read just after); its
    PSNR and SSIM against those recomputed from ``render_tiled``'s image
    with ``loss.psnr`` / ``loss.ssim`` (rel 1e-6); then ``export_ply`` ->
    ``import_ply`` -> render against the model's render (max abs 1e-6)."""
    C, E, R, LS = M.C, M.E, M.R, M.LS
    cfg = M.RasterizerConfig()
    torch.cuda.synchronize()
    for k in M.ALL_KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    rows = E.evaluate(model, cams, targets, cfg)
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t0) * 1e3
    launches = {k.symbol: k.launches for k in M.ALL_KERNELS}
    recomputed = []
    with torch.no_grad():
        for cam, target in zip(cams, targets):
            img = torch.clamp(R.render_tiled(model, cam, cfg), 0.0, 1.0)
            t = torch.as_tensor(target, device="cuda")
            recomputed.append((float(LS.psnr(img, t)),
                               float(LS.ssim(img, t))))
        path = os.path.join(tmp, "model.ply")
        t0 = time.perf_counter()
        C.export_ply(path, model)
        export_ms = (time.perf_counter() - t0) * 1e3
        back = C.import_ply(path, color_space=model.color_space,
                            device="cuda")
        ply_err = float((R.render_tiled(back, cams[0], cfg)
                         - R.render_tiled(model, cams[0], cfg)).abs().max())
    errs = [dict(psnr=abs(r["psnr"] - p) / abs(p),
                 ssim=abs(r["ssim"] - s) / abs(s))
            for r, (p, s) in zip(rows, recomputed)]
    n = len(cams)
    emit("eval_ref_init", views=n, width=cams[0].width,
         height=cams[0].height, rows=rows, recomputed=recomputed,
         rel_err_vs_recomputed=errs, launches=launches, eval_ms=eval_ms,
         ms_per_view=eval_ms / n,
         ply_bytes=os.path.getsize(path),
         ply_export_ms=export_ms, ply_round_trip_render_max_abs=ply_err,
         tolerance="PSNR/SSIM rel 1e-6; PLY round trip max abs 1e-6",
         card=card)
    check(launches["rasterize_fwd"] == n and launches["untile_chw"] == n,
          f"eval_ref_init: launches {launches}")
    check(all(e["psnr"] <= 1e-6 and e["ssim"] <= 1e-6 for e in errs),
          f"eval_ref_init: metrics differ from the recomputed ones: {errs}")
    check(not any(r["overflowed"] for r in rows[:-1])
          and rows[-1]["name"] == "mean",
          f"eval_ref_init: {rows}")
    check(ply_err <= 1e-6, f"eval_ref_init: PLY round trip {ply_err}")


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mesh_first_step(M, model, cam, target_hwc, cfg, mesh, ring):
    """The mesh path's loss and gradients of one step (no update), and
    this rank's strip of the target."""
    SP = M.SP
    strip_rows, padded_h = SP.strip_layout(cam.height, cfg.tile_size,
                                           mesh.size)
    row0 = mesh.rank * strip_rows
    target = SP.pad_rows(target_hwc, padded_h)[
        row0:row0 + strip_rows].contiguous()
    loss, grads, aux = SP.sharded_loss_and_grads(
        SP.shard_model(model, mesh), cam, target, mesh, cfg,
        M.TrainConfig().ssim_weight, ring=ring)
    return loss, grads, aux, target


def mesh_run(torch, M, scene, make_model, cam, target_hwc, cfg, mesh,
             single_ms, card, steps=10):
    """The mesh path at world size 1 (NCCL), ``ring=True``: the first
    step's loss and gradients (parameters and probe) against the single-card
    ``train_step``'s (fused loss B3) on the same model, bit for bit the same
    on repeat, ``ring=False`` against ``ring=True``; then ``steps``
    ``sharded_train_step``s (``run_steps``: B1 and B2 once per step, B3
    never, the loss falling), step ms beside the single-card step's.
    Returns (B1 and B2 launches, the first step's loss and gradients)."""
    model = make_model()
    target_chw = target_hwc.permute(2, 0, 1).contiguous()
    loss_1, _, _, _, grads_1 = M.T.camera_loss_and_grads(
        model, cam, None, None, target_chw, cfg, M.TrainConfig())
    loss_m, grads_m, aux, target = mesh_first_step(M, model, cam, target_hwc,
                                                   cfg, mesh, True)
    loss_2, grads_2, _, _ = mesh_first_step(M, model, cam, target_hwc, cfg,
                                            mesh, True)
    loss_g, grads_g, _, _ = mesh_first_step(M, model, cam, target_hwc, cfg,
                                            mesh, False)
    torch.cuda.synchronize()
    first = dict(
        loss_mesh=float(loss_m), loss_single_card=float(loss_1),
        loss_rel_err=abs(float(loss_m) - float(loss_1)) / float(loss_1),
        grad_rel_l2_vs_single_card={
            k: rel_l2(torch, grads_m[k], grads_1[k]) for k in grads_1},
        bit_equal_on_repeat=(torch.equal(loss_m, loss_2) and all(
            torch.equal(grads_m[k], grads_2[k]) for k in grads_m)),
        ring_false_loss_rel_err=abs(float(loss_g) - float(loss_m))
        / float(loss_m),
        ring_false_grad_rel_l2={k: rel_l2(torch, grads_g[k], grads_m[k])
                                for k in grads_m},
        ring_false_bit_equal=(torch.equal(loss_g, loss_m) and all(
            torch.equal(grads_g[k], grads_m[k]) for k in grads_m)),
        ring_false_grad_rel_l2_vs_single_card={
            k: rel_l2(torch, grads_g[k], grads_1[k]) for k in grads_1},
        overflowed=bool(aux["overflowed"]),
        ring_demand=float(aux["ring_demand"]),
        ring_emitted=float(aux["ring_emitted"]),
        tolerance="loss rel 1e-5; gradients relative L2 1e-4")
    del grads_2, grads_g

    shard = M.SP.shard_model(model, mesh)
    del model
    tcfg = M.TrainConfig()
    tx = M.T.make_optimizer(tcfg, 10.0)
    state = {"opt": tx.init({n: getattr(shard, n) for n in M.PARAM_NAMES}),
             "densify": M.D.DensifyState.zero(shard.capacity, mesh.device)}

    def step():
        _, state["opt"], state["densify"], metrics = M.SP.sharded_train_step(
            shard, state["opt"], state["densify"], cam, target, mesh, cfg,
            tcfg, tx)
        return metrics

    launches, _ = run_steps(
        torch, M, f"mesh_{scene}", step, shard,
        {"rasterize_fwd": 1, "rasterize_bwd": 1, "fused_loss": 0}, steps,
        cam.width * cam.height / 1e6, card,
        after=lambda: dict(mesh=mesh.shape, ring=True, first_step=first,
                           single_card_step_ms=single_ms))
    check(first["loss_rel_err"] <= 1e-5,
          f"mesh_{scene}: loss differs from the single card: {first}")
    check(max(first["grad_rel_l2_vs_single_card"].values()) <= 1e-4,
          f"mesh_{scene}: gradients differ from the single card: {first}")
    check(first["bit_equal_on_repeat"],
          f"mesh_{scene}: two passes on the card differ")
    check(first["ring_false_loss_rel_err"] <= 1e-5
          and max(first["ring_false_grad_rel_l2"].values()) <= 1e-4,
          f"mesh_{scene}: ring=False differs from ring=True: {first}")
    check(not first["overflowed"], f"mesh_{scene}: the pair pool overflowed")
    return ({"B1": launches["rasterize_fwd"], "B2": launches["rasterize_bwd"]},
            (loss_m, grads_m))


def mesh_trainer_run(torch, M, make_model, cam, target_hwc, cfg, mesh, tmp,
                     card):
    """``Trainer(mesh=...)`` on the card at a small scene: six steps with
    densify every 2 steps from step 2, prune and an opacity reset at step
    5; then, with densify off, six steps saving at 3 and 6 and a fresh mesh
    Trainer resumed from step 3 to 6, bit-equal to them, and the mesh's
    checkpoint resumed by a single-card Trainer, equal too."""
    T = M.T
    tcfg = M.TrainConfig(iterations=6, densify_start=2, densify_interval=2,
                         densify_grad_threshold=0.0, opacity_reset_interval=5)

    def trainer(tcfg, m=mesh, **kw):
        return T.Trainer(model=make_model(), cameras=[cam],
                         targets=[target_hwc], scene_extent=2.0, rcfg=cfg,
                         tcfg=tcfg, log_every=2, mesh=m, **kw)

    for k in M.ALL_KERNELS:
        k.launches = 0
    densified = trainer(tcfg)
    history = densified.run(6)
    torch.cuda.synchronize()
    launches = {k.symbol: k.launches for k in M.ALL_KERNELS if k.launches}
    initial = int(make_model().active.sum())

    ckpt = os.path.join(tmp, "mesh_ckpt")
    plain = dataclasses.replace(tcfg, densify_start=10 ** 9,
                                checkpoint_every=3)
    straight = trainer(plain, checkpoint_dir=ckpt)
    straight.run(6)
    resumed = trainer(plain, checkpoint_dir=ckpt)
    restored = resumed.resume(ckpt, step=3)
    resumed.run(3)
    one_card = trainer(plain, m=None)
    one_card.resume(ckpt, step=6)
    want = straight.gathered_model()
    equal = {
        name: {n: torch.equal(getattr(got, n), getattr(want, n))
               for n in M.PARAM_NAMES + ("active",)}
        for name, got in (("resumed", resumed.gathered_model()),
                          ("single_card_from_mesh_checkpoint",
                           one_card.model))}
    emit("mesh_trainer_small", mesh=mesh.shape, history=history,
         launches=launches, initial_active=initial, restored_step=restored,
         bit_equal_to_straight=equal, card=card)
    check(len(history) == 3 and all(math.isfinite(m["loss"])
                                    for m in history),
          f"mesh_trainer_small: {history}")
    check(history[-1]["num_active"] > initial,
          "mesh_trainer_small: densify added no gaussian")
    check(min(launches.get(k, 0) for k in ("rasterize_fwd",
                                           "rasterize_bwd")) >= 6
          and "fused_loss" not in launches,
          f"mesh_trainer_small: launches {launches}")
    check(restored == 3 and all(all(v.values()) for v in equal.values()),
          f"mesh_trainer_small: resume differs: {equal}")


def mesh_two_ranks(torch, M, first_1x1, tmp, card):
    """Where there are two cards, a 2-rank NCCL mesh (2x1) at ref_init in
    two processes of this script: the first step's loss on both ranks
    identical and equal to the 1x1 mesh's, its gathered gradients too, and
    three steps' losses identical and falling. With one card, says so."""
    n = torch.cuda.device_count()
    if n < 2:
        emit("mesh_2rank_ref_init", ran=False,
             reason=f"torch.cuda.device_count() is {n}: a 2-rank NCCL "
                    f"mesh needs two cards", card=card)
        return
    port, out = free_port(), os.path.join(tmp, "mesh2.pt")
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--mesh-rank",
         str(r), "--world", "2", "--port", str(port), "--out", out],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    texts = []
    try:
        for p in procs:
            texts.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    check(all(p.returncode == 0 for p in procs),
          f"mesh_2rank_ref_init: a rank failed: {texts}")
    ranks = [json.loads(next(line for line in reversed(t.splitlines())
                             if line.startswith('{"rank"')))
             for t in texts]
    grads = torch.load(out)
    loss_1, grads_1 = first_1x1
    err = {k: rel_l2(torch, grads[k].to(grads_1[k].device), grads_1[k])
           for k in grads_1}
    loss_err = abs(ranks[0]["first_loss"] - float(loss_1)) / float(loss_1)
    emit("mesh_2rank_ref_init", ran=True, ranks=ranks,
         loss_rel_err_vs_1x1=loss_err, grad_rel_l2_vs_1x1=err,
         tolerance="loss rel 1e-5; gradients relative L2 1e-4", card=card)
    check(ranks[0]["losses"] == ranks[1]["losses"]
          and ranks[0]["first_loss"] == ranks[1]["first_loss"],
          f"mesh_2rank_ref_init: the ranks' losses differ: {ranks}")
    check(loss_err <= 1e-5 and max(err.values()) <= 1e-4,
          f"mesh_2rank_ref_init: differs from the 1x1 mesh: {loss_err}, "
          f"{err}")
    check(ranks[0]["losses"][-1] < ranks[0]["losses"][0],
          "mesh_2rank_ref_init: the loss did not fall")


def mesh_rank_main(argv) -> int:
    """One rank of ``mesh_two_ranks``: ``chip_smoke.py --mesh-rank R
    --world N --port P --out FILE``. Prints its losses as the last line;
    rank 0 saves the first step's gathered gradients to FILE."""
    import numpy as np
    import torch
    import torch.distributed as dist

    opts = dict(zip(argv[::2], argv[1::2]))
    rank, world = int(opts["--mesh-rank"]), int(opts["--world"])
    sys.path.insert(0, str(REPO))
    from intro_to_gaussian_splatting_tpu_torch.config import (
        RasterizerConfig, TrainConfig,
    )
    from intro_to_gaussian_splatting_tpu_torch.io.synthetic import (
        random_point_cloud, ring_cameras,
    )
    from intro_to_gaussian_splatting_tpu_torch.models import (
        init_from_points, make_camera,
    )
    from intro_to_gaussian_splatting_tpu_torch.models.gaussians import (
        PARAM_NAMES,
    )
    from intro_to_gaussian_splatting_tpu_torch.parallel import (
        multihost as MH, sharded as SP,
    )
    from intro_to_gaussian_splatting_tpu_torch.train import densify as D
    from intro_to_gaussian_splatting_tpu_torch.train import trainer as T

    device = MH.init_multihost(f"127.0.0.1:{opts['--port']}", world, rank)
    try:
        mesh = MH.global_mesh(device=device)
        width, height = 5068, 3324
        xyz, rgb = random_point_cloud(52363, seed=0, extent=10.0)
        qvec, tvec = ring_cameras(1, width, height, radius=14.0, z=3.0,
                                  seed=0)[0]
        cam = make_camera(0.78 * width, 0.78 * width, width, height, qvec,
                          tvec, device=device)
        model = init_from_points(xyz, rgb, device=device)
        cfg, tcfg = RasterizerConfig(), TrainConfig()
        row0, rows = MH.process_local_rows(height, cfg.tile_size, mesh)
        target = torch.as_tensor(
            gradient_target(np, width, height)[row0:row0 + rows],
            device=device)
        target = SP.pad_rows(target, rows).contiguous()
        shard = SP.shard_model(model, mesh)
        loss, grads, _ = SP.sharded_loss_and_grads(
            shard, cam, target, mesh, cfg, tcfg.ssim_weight)
        whole = {k: MH.gather_rows(g, mesh).cpu() for k, g in grads.items()}
        tx = T.make_optimizer(tcfg, 10.0)
        opt = tx.init({n: getattr(shard, n) for n in PARAM_NAMES})
        dstate = D.DensifyState.zero(shard.capacity, device)
        losses = []
        for _ in range(3):
            _, opt, dstate, metrics = SP.sharded_train_step(
                shard, opt, dstate, cam, target, mesh, cfg, tcfg, tx)
            losses.append(float(metrics["loss"]))
        if rank == 0:
            torch.save(whole, opts["--out"])
        print(json.dumps(dict(rank=rank, mesh=mesh.shape,
                              first_loss=float(loss), losses=losses)),
              flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def cli_run(torch, M, tmp, card):
    """The CLI in-process on a small synthetic COLMAP scene with ground
    truth (300 points, 3 cameras, 64x48, its images rendered on the card):
    info, train (12 steps, holdout 3, checkpoints, eval at the end),
    train --resume to 18, eval with saved renders, points against the
    stored keypoints, and train --multihost in a world of one
    rank (NCCL, 6 steps through the mesh path). Each must exit 0 and each
    but info (which only reads the model files) print device=cuda; the
    training loss falls, the artifacts appear, the resume continues from
    step 12. Launches per command."""
    from intro_to_gaussian_splatting_tpu_torch import cli
    from intro_to_gaussian_splatting_tpu_torch.io.synthetic import (
        make_colmap_scene,
    )

    scene, out = os.path.join(tmp, "scene"), os.path.join(tmp, "out")
    out_mh = os.path.join(tmp, "out_multihost")
    make_colmap_scene(scene, num_points=300, num_cameras=3, width=64,
                      height=48, seed=5, write_images=True, device="cuda")
    ply = os.path.join(out, "point_cloud.ply")
    renders = os.path.join(out, "renders")
    commands = {
        "info": ["info", scene],
        "train": ["train", scene, "--iterations", "12", "--out-dir", out,
                  "--holdout", "3", "--checkpoint-every", "6",
                  "--eval-at-end"],
        "train_resume": ["train", scene, "--iterations", "18", "--out-dir",
                         out, "--resume"],
        "eval": ["eval", scene, "--ply", ply, "--holdout", "3",
                 "--save-renders", renders],
        "points": ["points", scene, "-o", os.path.join(out, "points.ppm"),
                   "--compare-keypoints"],
        "train_multihost": [
            "train", scene, "--multihost", "--coordinator",
            f"127.0.0.1:{free_port()}", "--num-processes", "1",
            "--process-id", "0", "--iterations", "6", "--out-dir", out_mh],
    }
    results, texts = {}, {}
    for name, argv in commands.items():
        for k in M.ALL_KERNELS:
            k.launches = 0
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        texts[name] = buf.getvalue()
        results[name] = dict(
            rc=rc, seconds=time.perf_counter() - t0,
            device_cuda="device=cuda" in texts[name],
            launches={k.symbol: k.launches for k in M.ALL_KERNELS
                      if k.launches},
            last_lines=texts[name].splitlines()[-4:])
    losses = [float(v) for v in re.findall(r"step \d+: loss ([\d.]+)",
                                           texts["train"])]
    artifacts = {a: os.path.exists(os.path.join(out, a))
                 for a in ("point_cloud.ply", "render.ppm", "metrics.jsonl")}
    kept = M.C.list_checkpoint_steps(os.path.join(out, "ckpt"))
    emit("cli_small", commands=results, train_losses=losses,
         artifacts=artifacts, checkpoints=kept,
         renders=sorted(os.listdir(renders)), card=card)
    check(all(r["rc"] == 0 and (r["device_cuda"] or name == "info")
              for name, r in results.items()), f"cli_small: {results}")
    check(len(losses) >= 2 and losses[-1] < losses[0],
          f"cli_small: the training loss did not fall: {losses}")
    check(all(artifacts.values()) and kept == [6, 12, 18],
          f"cli_small: artifacts {artifacts}, checkpoints {kept}")
    check("resumed from step 12 (6 iterations remaining)"
          in texts["train_resume"], "cli_small: resume did not continue")
    check(all(results["train"]["launches"].get(k, 0) >= 12
              for k in ("rasterize_fwd", "rasterize_bwd", "fused_loss")),
          f"cli_small: train launches {results['train']['launches']}")
    check("eval[holdout]" in texts["train"] and "mean" in texts["eval"]
          and "keypoint overlay" in texts["points"],
          "cli_small: missing output")
    mh = results["train_multihost"]["launches"]
    check("multihost: rank 0 of 1" in texts["train_multihost"]
          and all(os.path.exists(os.path.join(out_mh, a)) for a in artifacts)
          and mh.get("rasterize_fwd", 0) >= 6
          and mh.get("rasterize_bwd", 0) >= 6 and "fused_loss" not in mh,
          f"cli_small: train --multihost: {results['train_multihost']}")


def native_run(torch, np, M, model, cam, cfg, tmp, card):
    """The port's host C++ (utils/native.py), built with g++ on the card's
    machine: the scalar CPU oracle on the small scene's depth-sorted
    records, projected on the card and moved to the host, against the
    card's ``render_tiled`` (B1, B5-untile; launches counted from 0) and
    ``render_dense`` on the card (rtol 1e-4, atol 1e-5); the native COLMAP
    readers against the Python readers on a 4,000-point synthetic model,
    every array equal in value and dtype; then, with ``CXX=false`` and an
    empty build directory, ``read_model``'s fallback to the Python parser:
    one warning, nothing built, the native read's arrays. Times are host
    ms."""
    t0 = time.perf_counter()
    check(M.N.oracle_available() and M.N.colmap_available(),
          "native: no C++ compiler on PATH")
    build_s = time.perf_counter() - t0
    for k in M.ALL_KERNELS:
        k.launches = 0
    with torch.no_grad():
        tiled = M.R.render_tiled(model, cam, cfg).cpu().numpy()
        launches = {k.symbol: k.launches for k in M.ALL_KERNELS
                    if k.launches}
        dense = M.render_dense(model, cam, cfg).cpu().numpy()
        proj = M.project_gaussians(model, cam, cfg)
        rec, order = M.sorted_records(proj)
        rec, valid = rec.cpu().numpy(), proj.valid[order].cpu().numpy()
    t0 = time.perf_counter()
    oracle = M.N.oracle_render(rec, valid, cam.width, cam.height, cfg)
    oracle_ms = (time.perf_counter() - t0) * 1e3
    tol = dict(rtol=1e-4, atol=1e-5)

    sparse = M.make_colmap_scene(os.path.join(tmp, "colmap"),
                                 num_points=4000, num_cameras=8, seed=2,
                                 device="cuda")
    files = {stem: os.path.join(sparse, f"{stem}.bin")
             for stem in ("points3D", "images")}
    readers = {"points3D": M.CM.read_points3D_binary,
               "images": M.CM.read_images_binary}

    def read_all(times):
        got = {}
        for stem, read in readers.items():
            t0 = time.perf_counter()
            got[stem] = read(files[stem])
            times[stem].append((time.perf_counter() - t0) * 1e3)
        return got

    # five reads of each file by each reader, in turns; medians
    native_ms, python_ms = ({stem: [] for stem in readers} for _ in range(2))
    available = M.N.colmap_available
    for _ in range(5):
        native = read_all(native_ms)
        M.N.colmap_available = lambda: False      # the Python parsers
        try:
            python = read_all(python_ms)
        finally:
            M.N.colmap_available = available
    native_ms, python_ms = ({stem: sorted(v)[2] for stem, v in t.items()}
                            for t in (native_ms, python_ms))

    def fields(x):
        return dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x

    def same(a, b):
        a, b = fields(a), fields(b)
        return a.keys() == b.keys() and all(
            (isinstance(b[k], np.ndarray) and a[k].dtype == b[k].dtype
             and np.array_equal(a[k], b[k]))
            or (not isinstance(b[k], np.ndarray) and a[k] == b[k])
            for k in b)

    readers_equal = dict(
        points3D=same(native["points3D"], python["points3D"]),
        images=(list(native["images"]) == list(python["images"])
                and all(same(native["images"][i], python["images"][i])
                        for i in python["images"])))
    emit("native", build_s=build_s,
         oracle=dict(gaussians=model.capacity, width=cam.width,
                     height=cam.height, host_ms=oracle_ms,
                     max_abs_vs_render_tiled=float(np.abs(oracle
                                                          - tiled).max()),
                     max_abs_vs_render_dense=float(np.abs(oracle
                                                          - dense).max()),
                     render_tiled_launches=launches,
                     tolerance="rtol 1e-4, atol 1e-5"),
         colmap=dict(points=len(python["points3D"]),
                     images=len(python["images"]),
                     observations=int(python["points3D"].track_lengths.sum()),
                     native_host_ms_median=native_ms,
                     python_host_ms_median=python_ms,
                     equal=readers_equal),
         card=card)
    check(np.allclose(oracle, tiled, **tol),
          "native: the oracle disagrees with the card's render_tiled")
    check(np.allclose(oracle, dense, **tol),
          "native: the oracle disagrees with render_dense on the card")
    check(launches.get("rasterize_fwd", 0) >= 1,
          f"native: render_tiled did not launch B1: {launches}")
    check(all(readers_equal.values()),
          f"native: the native COLMAP readers differ: {readers_equal}")

    native_fallback_run(M, sparse, native, same, tmp, card)


def native_fallback_run(M, sparse, native, same, tmp, card):
    """A C++ build that fails (``CXX=false``, an empty build directory):
    ``read_model`` falls back to the Python parser with one warning, builds
    nothing, and reads ``native``, the native reader's read of ``sparse``;
    ``same`` compares two reads. The environment, the loaded libraries and
    the remembered build failure are restored after."""
    saved_env = {k: os.environ.get(k)
                 for k in ("CXX", "GSTPU_TORCH_BUILD_DIR")}
    saved_libs, saved_failed = dict(M.N._LIBS), M.CM._native_build_failed
    with tempfile.TemporaryDirectory(dir=tmp) as build, \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            os.environ.update(CXX="false", GSTPU_TORCH_BUILD_DIR=build)
            M.N._LIBS.clear()
            M.CM._native_build_failed = False
            t0 = time.perf_counter()
            _, images, points = M.CM.read_model(sparse)
            fallback_ms = (time.perf_counter() - t0) * 1e3
            built = sorted(os.listdir(build))
        finally:
            for k, v in saved_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            M.N._LIBS.clear()
            M.N._LIBS.update(saved_libs)
            M.CM._native_build_failed = saved_failed
    warned = [str(w.message) for w in caught]
    fallback_warned = len(warned) == 1 and "Python parser" in warned[0]
    fallback_equal = dict(
        points3D=same(points, native["points3D"]),
        images=(list(images) == list(native["images"])
                and all(same(images[i], native["images"][i])
                        for i in images)))
    emit("native_fallback", host_ms=fallback_ms,
         fallback_warned=fallback_warned, warnings=warned,
         build_dir_files=built, equal=fallback_equal, card=card)
    check(fallback_warned and not built,
          f"native: the fallback warned {warned}, built {built}")
    check(all(fallback_equal.values()),
          f"native: the fallback's read differs: {fallback_equal}")


def train_curve_run(torch, M, tmp, card, steps):
    """The port's training-curve script in this process, at its defaults
    but ``--steps``, on the card (scripts/train_curve.py): the targets
    rendered on the card (B1 and B5-untile once per camera), then the
    Trainer's run with every launch count set to 0 just before and read
    just after. Gates: every logged loss and PSNR finite, PSNR climbing by
    more than 1 dB, B1, B2, B3 and G1 launched exactly once per step, and
    ``num_active`` moving at a densify step."""
    args = M.TC.parse_args(["--steps", str(steps), "--out",
                            os.path.join(tmp, "train_curve.jsonl")])
    for k in M.ALL_KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    problem = M.TC.make_problem(args)
    torch.cuda.synchronize()
    problem_s = time.perf_counter() - t0
    target_launches = {k.symbol: k.launches for k in M.ALL_KERNELS
                       if k.launches}
    for k in M.ALL_KERNELS:
        k.launches = 0
    summary = M.TC.run_problem(problem)
    launches = {k.symbol: k.launches for k in M.ALL_KERNELS if k.launches}
    with open(args.out) as f:
        rows = [json.loads(line) for line in f][:-1]
    emit("train_curve", problem_seconds=problem_s,
         target_launches=target_launches, launches_in_run=launches,
         summary=summary, card=card)
    check(all(math.isfinite(r["loss"]) and math.isfinite(r["psnr"])
              for r in rows) and len(rows) == len(summary["curve"]),
          "train_curve: a logged loss or PSNR is not finite")
    check(summary["final_psnr"] > summary["first_psnr"] + 1.0,
          f"train_curve: PSNR did not climb by more than 1 dB "
          f"({summary['first_psnr']} -> {summary['final_psnr']})")
    check(all(launches.get(k) == steps for k in
              ("rasterize_fwd", "rasterize_bwd", "fused_loss",
               "segment_sums")),
          f"train_curve: not one B1, B2, B3 and G1 per step: {launches}")
    check(target_launches.get("rasterize_fwd") == args.cameras
          and target_launches.get("untile_chw") == args.cameras,
          f"train_curve: target renders launched {target_launches}")
    check(any(p["active_after"] != p["active_before"]
              for p in summary["densify_passes"]),
          f"train_curve: densify never moved num_active: "
          f"{summary['densify_passes']}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (REPO / PACKAGE / "__init__.py").is_file():
        print(f"chip_smoke: {PACKAGE}/ not found beside this script; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))

    from intro_to_gaussian_splatting_tpu_torch.config import (
        RasterizerConfig, TrainConfig,
    )
    from intro_to_gaussian_splatting_tpu_torch.io.synthetic import (
        random_point_cloud, ring_cameras,
    )
    from intro_to_gaussian_splatting_tpu_torch.models import (
        GaussianModel, index_camera, init_from_points, make_camera,
        stack_cameras,
    )
    from intro_to_gaussian_splatting_tpu_torch.models.gaussians import (
        PARAM_NAMES,
    )
    from intro_to_gaussian_splatting_tpu_torch.ops import binning as B
    from intro_to_gaussian_splatting_tpu_torch.ops import cuda_build
    from intro_to_gaussian_splatting_tpu_torch.ops import fused_loss as FL
    from intro_to_gaussian_splatting_tpu_torch.ops import probe as P
    from intro_to_gaussian_splatting_tpu_torch.ops import projection as J
    from intro_to_gaussian_splatting_tpu_torch.ops import rasterize as R
    from intro_to_gaussian_splatting_tpu_torch.ops import relayout as L
    from intro_to_gaussian_splatting_tpu_torch.ops import ssim as S
    from intro_to_gaussian_splatting_tpu_torch.io import colmap as CM
    from intro_to_gaussian_splatting_tpu_torch.io.synthetic import (
        make_colmap_scene,
    )
    from intro_to_gaussian_splatting_tpu_torch.scripts import (
        probe_kernel as PK,
        train_curve as TC,
    )
    from intro_to_gaussian_splatting_tpu_torch.train import checkpoint as C
    from intro_to_gaussian_splatting_tpu_torch.train import densify as D
    from intro_to_gaussian_splatting_tpu_torch.train import evaluate as E
    from intro_to_gaussian_splatting_tpu_torch.train import loss as LS
    from intro_to_gaussian_splatting_tpu_torch.train import trainer as T
    from intro_to_gaussian_splatting_tpu_torch.utils import native as N
    from intro_to_gaussian_splatting_tpu_torch.utils import profiling as U
    from intro_to_gaussian_splatting_tpu_torch.ops.binning import (
        bin_gaussians, num_groups_for, tile_grid,
    )
    from intro_to_gaussian_splatting_tpu_torch.ops.compositing import (
        render_dense, sorted_records,
    )
    from intro_to_gaussian_splatting_tpu_torch.ops.projection import (
        GRAD_ROWS, project_gaussians,
    )
    from intro_to_gaussian_splatting_tpu_torch.ops.render import render
    from intro_to_gaussian_splatting_tpu_torch.parallel import (
        multihost as MH, sharded as SP,
    )
    from gsbench import counts as K
    from gsbench import scene as GS

    import numpy as np

    M = types.SimpleNamespace(
        B=B, R=R, L=L, FL=FL, S=S, D=D, T=T, P=P, PK=PK, C=C, U=U, E=E,
        LS=LS, K=K, J=J, GS=GS, make_camera=make_camera,
        SP=SP, N=N, TC=TC, CM=CM, cuda_build=cuda_build,
        GaussianModel=GaussianModel, render_dense=render_dense,
        sorted_records=sorted_records, make_colmap_scene=make_colmap_scene,
        TrainConfig=TrainConfig, RasterizerConfig=RasterizerConfig,
        PARAM_NAMES=PARAM_NAMES, tile_grid=tile_grid,
        num_groups_for=num_groups_for, bin_gaussians=bin_gaussians,
        project_gaussians=project_gaussians, GRAD_ROWS=GRAD_ROWS,
        init_from_points=init_from_points,
        ALL_KERNELS=(R.RASTERIZE_FWD, R.RASTERIZE_BWD, FL.FUSED_LOSS,
                     L.UNTILE_CHW, L.TILE_CHW, S.SSIM_SUM, S.SSIM_GRAD,
                     S.SSIM_VALUE_GRAD, P.PROBE_ZERO, P.PROBE_WINDOW,
                     B.SEGMENT_SUMS, J.PROJECT_FWD, J.PROJECT_BWD))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi_line()
    t0 = time.perf_counter()
    sources = list(dict.fromkeys(k.source for k in M.ALL_KERNELS))
    cuda_build.build(sources)
    build_s = time.perf_counter() - t0
    emit("device", card=card, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         build_s=build_s,
         ptxas={src.name: cuda_build.ptxas_report(src) for src in sources})

    # -- small seeded scenes: 400 gaussians of 0.02-0.25 (the host C++
    # phase), 200 of 0.08-0.3 with a target (the batched step, the Trainer
    # and the mesh Trainer)
    rng = np.random.default_rng(3)
    n, w, h = 400, 48, 32
    qvec, tvec = ring_cameras(1, w, h, radius=5.0, z=1.0, seed=3)[0]
    arrays = dict(
        means=rng.normal(0.0, 1.2, size=(n, 3)),
        colors=rng.uniform(0.0, 1.0, size=(n, 3)),
        log_scales=np.log(rng.uniform(0.02, 0.25, size=(n, 3))),
        quats=rng.normal(size=(n, 4)),
        opacity_logits=rng.uniform(-2.0, 6.0, size=(n,)))
    small_cfg = RasterizerConfig(pairs_per_gaussian=32, group_tiles=2)

    def small_model(dev, arrays=arrays):
        n = len(arrays["means"])

        def f32(x):
            return torch.as_tensor(x, dtype=torch.float32, device=dev)
        return GaussianModel(
            means=f32(arrays["means"]), log_scales=f32(arrays["log_scales"]),
            quats=f32(arrays["quats"]),
            opacity_logits=f32(arrays["opacity_logits"]),
            sh=f32(arrays["colors"])[:, None, :],
            active=torch.ones(n, dtype=torch.bool, device=dev),
            color_space="rgb")

    rng = np.random.default_rng(11)
    train_arrays = dict(
        means=rng.normal(0.0, 1.2, size=(200, 3)),
        colors=rng.uniform(0.0, 1.0, size=(200, 3)),
        log_scales=np.log(rng.uniform(0.08, 0.3, size=(200, 3))),
        quats=rng.normal(size=(200, 4)),
        opacity_logits=rng.uniform(-2.0, 4.0, size=(200,)))
    target_small = torch.as_tensor(rng.uniform(0.0, 1.0, size=(3, h, w)),
                                   dtype=torch.float32)

    # -- train_step_batched on the card: one Adam step on the mean of two
    # cameras' gradients, read back from the first moments (mu = 0.1 g)
    poses = ring_cameras(2, w, h, radius=5.0, z=1.0, seed=4)
    cams = [make_camera(0.9 * max(w, h), 0.9 * max(w, h), w, h, q, t,
                        device="cuda") for q, t in poses]
    model = small_model("cuda", train_arrays)
    targets = torch.stack([target_small, target_small.flip(2)]).cuda()
    tcfg = TrainConfig()
    per_camera = [T.camera_loss_and_grads(model, c, None, None, t, small_cfg,
                                          tcfg)[4]
                  for c, t in zip(cams, targets)]
    mean = {k: (per_camera[0][k] + per_camera[1][k]) / 2
            for k in PARAM_NAMES}
    tx = T.make_optimizer(tcfg, 2.0)
    state = tx.init({k: getattr(model, k) for k in PARAM_NAMES})
    _, state, dstate, metrics = T.train_step_batched(
        model, state, D.DensifyState.zero(model.capacity, "cuda"),
        stack_cameras(cams), None, None, targets, small_cfg, tcfg, tx)
    batched_err = {k: rel_l2(torch, state[k].mu / (1 - T.ADAM_B1), mean[k])
                   for k in PARAM_NAMES}
    visible_twice = int((dstate.count == 2).sum())
    emit("small_batched", cameras=2, grad_rel_l2_vs_mean=batched_err,
         loss=float(metrics["loss"]), gaussians_seen_by_both=visible_twice,
         tolerance="relative L2 1e-6")
    check(max(batched_err.values()) <= 1e-6,
          f"small_batched: not the mean gradient: {batched_err}")
    check(visible_twice > 0, "small_batched: densify counts not per camera")

    # -- the Trainer loop on the card: the same scene in a pool with free
    # slots, densify every 2 steps from step 2, an opacity reset at step 5
    pool = {k: np.concatenate([v, v[:1].repeat(len(v), axis=0)])
            for k, v in train_arrays.items()}

    def pool_model():
        model = small_model("cuda", pool)
        with torch.no_grad():
            model.active[len(train_arrays["means"]):] = False
            model.opacity_logits[len(train_arrays["means"]):] = -20.0
        return model

    model = pool_model()
    cam = small_cam = make_camera(0.9 * max(w, h), 0.9 * max(w, h), w, h,
                                  qvec, tvec, device="cuda")
    tcfg = TrainConfig(iterations=6, densify_start=2, densify_interval=2,
                       densify_grad_threshold=0.0, opacity_reset_interval=5)
    for k in M.ALL_KERNELS:
        k.launches = 0
    trainer = T.Trainer(model=model, cameras=[cam],
                        targets=[target_small.permute(1, 2, 0).numpy()],
                        scene_extent=2.0, rcfg=small_cfg, tcfg=tcfg,
                        log_every=2)
    history = trainer.run(6)
    launches = {k.symbol: k.launches for k in M.ALL_KERNELS}
    emit("small_trainer", history=history, launches=launches,
         capacity=model.capacity)
    check(len(history) == 3 and all(math.isfinite(m["loss"])
                                    for m in history),
          f"small_trainer: {history}")
    check(history[-1]["num_active"] > len(train_arrays["means"]),
          "small_trainer: densify added no gaussian")
    check(min(launches[k] for k in ("rasterize_fwd", "rasterize_bwd",
                                    "fused_loss")) >= 6,
          f"small_trainer: a kernel of the step was not launched: "
          f"{launches}")

    # -- treehill-scale scene, exactly as bench.py builds it
    width, height = 5068, 3324
    xyz, rgb = random_point_cloud(52363, seed=0, extent=10.0)
    qvec, tvec = ring_cameras(1, width, height, radius=14.0, z=3.0,
                              seed=0)[0]
    focal = 0.78 * width
    cam = make_camera(focal, focal, width, height, qvec, tvec, device="cuda")
    ts = 16
    ntx, nty = tile_grid(width, height, ts)
    mpix = width * height / 1e6
    scenes = {
        "ref_init": (init_from_points(xyz, rgb, device="cuda"),
                     RasterizerConfig()),
        "knn_init": (init_from_points(xyz, rgb, scale_init=None, opacity=0.9,
                                      device="cuda"),
                     RasterizerConfig(pairs_per_gaussian=585, group_tiles=16,
                                      groups_per_step=16)),
    }

    summary = {}
    for scene, (model, cfg) in scenes.items():
        ng = num_groups_for(ntx * nty, cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        R.RASTERIZE_FWD.launches = 0
        L.UNTILE_CHW.launches = 0
        J.PROJECT_FWD.launches = 0
        t0 = time.perf_counter()
        with torch.no_grad():
            image = render(model, cam, cfg, backend="auto")
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        launches = {"B1": R.RASTERIZE_FWD.launches,
                    "B5-untile": L.UNTILE_CHW.launches,
                    "J1": J.PROJECT_FWD.launches}
        peak = torch.cuda.max_memory_allocated()
        with torch.no_grad():
            proj = project_gaussians(model, cam, cfg)
            bins = bin_gaussians(proj, width, height, cfg)
        num_pairs = int(bins.num_pairs)
        overflowed = bool(bins.overflowed)
        finite = bool(torch.isfinite(image).all())
        emit(scene, gaussians=model.capacity, width=width, height=height,
             config=dict(pairs_per_gaussian=cfg.pairs_per_gaussian,
                         group_tiles=cfg.group_tiles,
                         groups_per_step=cfg.groups_per_step),
             launches=launches, num_pairs=num_pairs,
             num_pairs_jax_package=JAX_PAIRS[scene],
             pool_slots=bins.pair_records.shape[1], overflowed=overflowed,
             image_shape=list(image.shape), finite=finite,
             image_mean=float(image.mean()), first_render_ms=first_ms,
             max_memory_allocated=peak, card=card)
        check(all(v >= 1 for v in launches.values()),
              f"{scene}: a kernel of the path was not launched: {launches}")
        check(tuple(image.shape) == (height, width, 3) and finite,
              f"{scene}: image is not a finite (H, W, 3) tensor")
        check(not overflowed, f"{scene}: the pair pool overflowed")
        check(abs(num_pairs - JAX_PAIRS[scene]) <= 0.01 * JAX_PAIRS[scene],
              f"{scene}: {num_pairs} pairs, the JAX package counts "
              f"{JAX_PAIRS[scene]}")

        # -- each kernel against its plain version on this scene's inputs
        args = (bins.pair_records, bins.tile_starts, bins.tile_counts, ng,
                cfg)
        with torch.no_grad():
            tiles = R.rasterize_pairs(*args)
            plain, evaluations, pairs_read = R.rasterize_pairs_reference(
                *args, count_evaluations=True)
        torch.cuda.synchronize()
        b1_err = (tiles - plain).abs().amax(dim=(0, 2, 3)).tolist()
        b1_ok = torch.allclose(tiles, plain, rtol=1e-4, atol=1e-5)
        # reported beside the gate, which alone decides
        b1_bit_equal = torch.equal(tiles, plain)
        chw = L.untile_chw_fast(tiles, ntx, nty, ts, height, width)
        chw_plain = L.untile_chw(tiles[:, :3], ntx, nty, ts, height, width)
        b5_err = float((chw - chw_plain).abs().max())
        b5_ok = torch.equal(chw, chw_plain)

        # -- times
        b1_times = profiled(M, lambda: R.rasterize_pairs(*args),
                            ("rasterize_fwd_kernel",))
        b1_plain_ms = M.U.cuda_ms(
            lambda: R.rasterize_pairs_reference(*args), iters=1,
            warmup=0)
        b1_bytes, b1_ops = K.b1(dict(evaluations=evaluations,
                                     pairs_read=pairs_read), ntx * nty, ts)
        b1_bound, b1_by = bound_of(M, b1_bytes, b1_ops)
        b5_plain_ms = M.U.cuda_ms(lambda: L.untile_chw(
            tiles[:, :3], ntx, nty, ts, height, width), iters=10)
        # the library yardstick: the tile -> image-row transposition as one
        # permute + contiguous of the channel-major flattened tiles
        flat = tiles[:, :3].permute(1, 0, 2, 3).reshape(
            3, -1, ts * ts)[:, :ntx * nty].reshape(3, nty, ntx, ts, ts)
        b5_times = in_turns(
            M, lambda: L.untile_chw_fast(tiles, ntx, nty, ts, height, width),
            lambda: flat.permute(0, 1, 3, 2, 4).contiguous())
        b5_bytes, b5_ops = K.b5_untile(width, height)
        b5_bound, b5_by = bound_of(M, b5_bytes, b5_ops)

        # the layout of one tile per group: more groups than the grid's
        # 65,535 in y and z, the same image as the default layout (binning
        # gives each tile the same pairs in both)
        one_per_group = {}
        if scene == "ref_init":
            cfg1 = dataclasses.replace(cfg, group_tiles=1)
            with torch.no_grad():
                image1 = R.render_tiled(model, cam, cfg1)
            torch.cuda.synchronize()
            one_per_group = dict(
                groups=num_groups_for(ntx * nty, cfg1),
                equal_to_default=torch.equal(image1, image),
                max_abs_diff=float((image1 - image).abs().max()))
            del image1

        rows = [
            dict(name="B1 rasterize_fwd", route="cuda",
                 source=f"{PACKAGE}/csrc/rasterize_fwd.cu",
                 replaces=B1_REPLACES, launches=launches["B1"],
                 max_abs_err=max(b1_err), **b1_times, plain_ms=b1_plain_ms,
                 bound_ms=b1_bound, bound_by=b1_by, library_ms=None),
            b5_row(b5_times, b5_bytes, 2 * 3 * ntx * nty * ts * ts * 4,
                   name="B5-untile untile_chw", route="cuda",
                   source=f"{PACKAGE}/csrc/untile_chw.cu",
                   replaces=B5_REPLACES, launches=launches["B5-untile"],
                   max_abs_err=b5_err, plain_ms=b5_plain_ms,
                   bound_ms=b5_bound, bound_by=b5_by),
        ]
        emit(f"{scene}_kernels", kernels=rows,
             b1_max_abs_err_per_channel=b1_err, b1_within_tolerance=b1_ok,
             b1_tolerance="rtol 1e-4, atol 1e-5",
             b1_bit_equal_to_plain=b1_bit_equal, b1_evaluations=evaluations,
             b1_pairs_read=pairs_read, b1_bytes=b1_bytes,
             b5_exactly_equal=b5_ok, one_tile_per_group=one_per_group,
             card=card)
        check(not one_per_group or (one_per_group["groups"] > 65535
                                    and one_per_group["equal_to_default"]),
              f"{scene}: the render at group_tiles=1 differs from the "
              f"default: {one_per_group}")
        check(b1_ok, f"{scene}: B1 disagrees with its plain version "
                     f"(max abs per channel {b1_err})")
        check(b5_ok, f"{scene}: B5-untile differs from its plain version")
        summary[scene] = rows
        del tiles, plain, chw, chw_plain, flat, bins, proj, image
        torch.cuda.empty_cache()

    # -- training: ten steps per scene, the render gradient (B5-tile), and
    # the training kernels against their plain versions on the real inputs
    target_hwc = torch.as_tensor(gradient_target(np, width, height),
                                 device="cuda")
    target = target_hwc.permute(2, 0, 1).contiguous()
    single_step_ms = {}
    for scene, (model, cfg) in scenes.items():
        launches, single_step_ms[scene] = train_run(torch, M, scene, model,
                                                    cam, target, cfg, card)
        grad_launches, g_img = render_grad_run(torch, M, scene, model, cam,
                                               target_hwc, cfg, card)
        rows = train_kernels(torch, M, scene, model, cam, target, g_img, cfg,
                             launches, grad_launches, card)
        if scene == "ref_init":
            summary[scene] = summary[scene] + rows
        del g_img
        torch.cuda.empty_cache()

    # -- G1 at the treehill_3dgs train cell's pool (the KNN init among 3x
    # as many free slots, 256 pairs per gaussian), then at the
    # treehill_3dgs_30k cell's 3.1M gaussians (16 pairs per gaussian)
    g1_rows = [g1_kernel(torch, M, "train_cell", init_from_points(
        xyz, rgb, scale_init=None, opacity=0.9, capacity=4 * len(xyz),
        device="cuda"), cam, RasterizerConfig(
            pairs_per_gaussian=256, group_tiles=16, groups_per_step=16),
        card)]
    torch.cuda.empty_cache()
    g1_rows.append(g1_kernel(torch, M, "30k", *scene_30k(M),
                             RasterizerConfig(pairs_per_gaussian=16,
                                              group_tiles=16,
                                              groups_per_step=16,
                                              cov2d_dilation=0.3), card))
    torch.cuda.empty_cache()

    # -- J1 and J2 at both cells' shapes
    j_rows = projection_kernels(torch, M, xyz, rgb, cam, card)
    torch.cuda.empty_cache()

    # -- the split-loss SSIM kernels at the training path's size, then the
    # split-loss and batched training paths at the ref_init scene
    b4_rows = ssim_kernels(torch, M, height, width, card)
    torch.cuda.empty_cache()
    cfg = RasterizerConfig()
    model = init_from_points(xyz, rgb, device="cuda")
    split_step, _ = make_step(
        M, T.train_step, model, cam,
        (R.image_to_tiles(target_hwc, cfg),
         R.tile_pixel_mask(height, width, cfg, "cuda"), target),
        cfg, TrainConfig(fused_loss=False))
    one_each = {k.symbol: 1 for k in (R.RASTERIZE_FWD, R.RASTERIZE_BWD,
                                      S.SSIM_SUM, S.SSIM_GRAD, L.UNTILE_CHW,
                                      L.TILE_CHW, B.SEGMENT_SUMS,
                                      J.PROJECT_FWD, J.PROJECT_BWD)}
    split_launches, _ = run_steps(torch, M, "train_split_ref_init", split_step,
                               model, dict(one_each, fused_loss=0), 10, mpix,
                               card)
    b4_rows[0]["launches"] = split_launches["ssim_sum"]
    b4_rows[1]["launches"] = split_launches["ssim_grad"]
    del split_step
    torch.cuda.empty_cache()

    model = init_from_points(xyz, rgb, device="cuda")
    cams = stack_cameras([
        make_camera(focal, focal, width, height, q, t, device="cuda")
        for q, t in ring_cameras(2, width, height, radius=14.0, z=3.0,
                                 seed=0)])
    batched_step, _ = make_step(
        M, T.train_step_batched, model, cams,
        (None, None, torch.stack([target, target.flip(2)])), cfg,
        TrainConfig())
    run_steps(torch, M, "train_batched_ref_init", batched_step, model,
              {"rasterize_fwd": 2, "rasterize_bwd": 2, "fused_loss": 2,
               "segment_sums": 2, "project_fwd": 2, "project_bwd": 2}, 5,
              2 * mpix, card)
    del batched_step, model
    torch.cuda.empty_cache()

    # -- the probes, then checkpoint / resume and evaluation at the ref_init
    # scene, the mesh path, and the CLI on a small scene, in a directory of
    # the checkout
    p_rows = probes(torch, np, M, card)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=REPO, prefix=".chip_smoke-") as tmp:
        trained = checkpoint_run(torch, M, xyz, rgb, cam, target_hwc, tmp,
                                 card)
        eval_targets = [gradient_target(np, width, height)]
        eval_targets.append(eval_targets[0][:, ::-1].copy())
        eval_run(torch, M, trained, [index_camera(cams, i) for i in (0, 1)],
                 eval_targets, tmp, card)
        del trained, cams
        torch.cuda.empty_cache()

        # -- the mesh path in a world of one rank on the card (NCCL): the
        # treehill scene at both inits, the mesh Trainer at the small scene,
        # and a 2-rank mesh where there are two cards
        import torch.distributed as dist
        device = MH.init_multihost(f"127.0.0.1:{free_port()}", 1, 0)
        mesh = MH.global_mesh(device=device)
        inits = {
            "ref_init": lambda: init_from_points(xyz, rgb, device="cuda"),
            "knn_init": lambda: init_from_points(
                xyz, rgb, scale_init=None, opacity=0.9, device="cuda"),
        }
        mesh_launches = {}
        for scene, (_, cfg) in scenes.items():
            mesh_launches[scene], first = mesh_run(
                torch, M, scene, inits[scene], cam, target_hwc, cfg, mesh,
                single_step_ms[scene], card)
            if scene == "ref_init":
                first_ref = first
            del first
            torch.cuda.empty_cache()
        mesh_trainer_run(torch, M, pool_model, small_cam,
                         target_small.permute(1, 2, 0).cuda(), small_cfg,
                         mesh, tmp, card)
        dist.destroy_process_group()
        mesh_two_ranks(torch, M, first_ref, tmp, card)
        del first_ref
        for row in summary["ref_init"]:
            key = row["name"].split()[0]
            if key in mesh_launches["ref_init"]:
                row["mesh_launches"] = mesh_launches["ref_init"][key]
        cli_run(torch, M, tmp, card)

        # -- the host C++ on the card's machine, then the training curve
        native_run(torch, np, M, small_model("cuda"), small_cam, small_cfg,
                   tmp, card)
        train_curve_run(torch, M, tmp, card, TRAIN_CURVE_STEPS)

    print(card, flush=True)
    print(json.dumps({"kernels": summary["ref_init"] + b4_rows + p_rows
                      + g1_rows + j_rows}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if "--mesh-rank" in sys.argv:
        sys.exit(mesh_rank_main(sys.argv[1:]))
    sys.exit(main())
