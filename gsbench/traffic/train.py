"""Traffic ``train``: the port's training loop, ``Trainer.run``, as
``gstpu-torch train`` runs it, on the cell's scene, cameras and targets.

Set-up builds one ``Trainer`` (the configuration's ``TrainConfig`` with the
run's seed, a pool of ``capacity_multiplier`` times the gaussians), sets
its step counter to ``first_step - 1`` as ``resume`` would, and drives it
through ``setup_steps`` steps in one ``Trainer.run`` at the window's own
log cadence, so that the steps queue on the card with no host sync
between them, as in the window. Of the first ``checked_steps`` the
benchmark keeps, by copies made on the card in stream order, each step's
loss, Adam's first moment after the first and the parameters and active
slots after the last (its densify and prune pass included). The window is
one ``Trainer.run`` that stops at the first log row (every ``log_every``
steps, a host sync) after ``--seconds``; ``train_step_ms`` is the window's
host time over the steps it completed, densify passes and log syncs
included. After the window the program is freed and the plain reference
follows the checked steps from the same initial state, cameras and
targets; the losses, the first gradient and the parameters' change after
the checked steps are compared leaf by leaf.

With ``--trace 1`` the window is ``trace_steps`` steps run untraced and
host-timed, then as many under the profiler, followed by the stage times
of ``stage_reps`` steps (host clock, synchronised after each stage) and
the reference's count of the work of each camera at the model's state.
"""

from __future__ import annotations

import gc
import math
import statistics
import time

import numpy as np
import torch

from gsbench import scene, sides, tracing
from gsbench.harness import Outcome, Readings, relative_gap, sync
from gsbench.reference.train import NAMES, RefTrainer

# leaves whose reference gradient is under this share of the median
# leaf's move by round-off alone and are left out of the change
NEGLIGIBLE_GRADIENT = 1e-3


class _WindowClosed(Exception):
    pass


def _inputs(cell):
    cfg, p, dev = cell.config, cell.params, cell.device
    gen = scene.generator(cell.seed, dev)
    xyz, rgb = scene.point_cloud(cfg, gen, dev)
    capacity = int(cfg["num_gaussians"] * cfg["train"]["capacity_multiplier"])
    params, active = scene.initial_params(cfg, xyz, rgb, capacity, gen)
    poses = scene.ring_poses(cfg, p["cameras"], cell.seed)
    targets = scene.targets(cfg, p["cameras"], gen, dev)
    return params, active, scene.extent_of(xyz), poses, targets


def _order(cell, steps: int):
    """The cameras of the loop's first ``steps`` steps: the Trainer draws
    a permutation of ``arange(steps) % cameras`` from its seed."""
    return np.random.default_rng(cell.seed).permutation(
        np.arange(steps) % cell.params["cameras"])


def _program(cell, params, active, extent, poses, targets):
    from intro_to_gaussian_splatting_tpu_torch.config import (
        RasterizerConfig,
        TrainConfig,
    )
    from intro_to_gaussian_splatting_tpu_torch.train.trainer import Trainer

    model, cams = sides.program_scene(cell, params, active, poses)
    trainer = Trainer(model=model, cameras=cams, targets=targets,
                      scene_extent=extent,
                      rcfg=RasterizerConfig(**cell.rasterizer()),
                      tcfg=TrainConfig(**cell.config["train"],
                                       seed=cell.seed),
                      log_every=cell.params["log_every"])
    trainer.step = cell.params["first_step"] - 1
    return trainer


def _setup_run(trainer, checked: int, steps: int) -> dict:
    """``steps`` steps in one ``Trainer.run``; what the check needs of the
    first ``checked``, copied on the card as each is done."""
    losses, first_mu, kept = [], {}, {}
    train_unit, maybe_densify = trainer._train_unit, trainer._maybe_densify

    def unit(u):
        m = train_unit(u)
        if len(losses) < checked:
            losses.append(m["loss"].detach().clone())
            if len(losses) == 1:
                first_mu.update({k: g.mu.detach().clone()
                                 for k, g in trainer.opt_state.items()})
        return m

    def densify():
        maybe_densify()
        if len(losses) == checked and not kept:
            kept.update(params={k: getattr(trainer.model, k).detach().clone()
                                for k in NAMES},
                        active=trainer.model.active.clone())

    trainer._train_unit, trainer._maybe_densify = unit, densify
    try:
        trainer.run(steps)
    finally:
        del trainer._train_unit, trainer._maybe_densify
    return dict(
        losses=[float(x) for x in losses],
        overflow=_overflowed(trainer),
        # Adam's first moment after one step is (1 - b1) * gradient
        grads={k: first_mu[k] / 0.1 for k in NAMES}, **kept)


def _overflowed(trainer) -> int:
    """The steps so far whose pair pool overflowed: the Trainer's own
    count on the card (its log rows leave out those that a densify pass
    meets first)."""
    return int(trainer._overflow_count)


def _window(cell, trainer):
    """Steps until the first log row after ``cell.seconds``: (steps,
    seconds, log rows)."""
    rows = []
    t0 = time.perf_counter()
    deadline = t0 + cell.seconds

    def on_log(m):
        if "event" not in m:
            rows.append(m)
            if time.perf_counter() >= deadline:
                raise _WindowClosed

    step0 = trainer.step
    trainer.on_log = on_log
    try:
        trainer.run(cell.params["max_steps"])
    except _WindowClosed:
        pass
    sync(cell.device)
    seconds = time.perf_counter() - t0
    trainer.on_log = None
    return trainer.step - step0, seconds, rows


def _stage_ms(cell, trainer, cam, target_chw, reps: int) -> dict:
    """Host ms of each layer of one training step, synchronised after
    each (mean of ``reps`` steps; the model keeps training). The layers
    are called here as ``train_step`` calls them: a copy of its
    layering, which times the old split if the program's step changes
    shape, until the program's own spans replace it."""
    from intro_to_gaussian_splatting_tpu_torch.models.gaussians import (
        PARAM_NAMES,
    )
    from intro_to_gaussian_splatting_tpu_torch.ops.binning import tile_grid
    from intro_to_gaussian_splatting_tpu_torch.ops.fused_loss import (
        fused_photometric_loss,
    )
    from intro_to_gaussian_splatting_tpu_torch.ops.rasterize import (
        render_tiles,
    )
    from intro_to_gaussian_splatting_tpu_torch.train import densify

    model, rcfg, tcfg = trainer.model, trainer.rcfg, trainer.tcfg
    h, w = cam.height, cam.width
    ntx, nty = tile_grid(w, h, rcfg.tile_size)
    names = ("render", "loss", "backward", "optimizer", "densify")
    sums = dict.fromkeys(names, 0.0)
    for _ in range(reps):
        sync(cell.device)
        marks = [time.perf_counter()]
        probe = torch.zeros((model.capacity, 2), device=cell.device,
                            requires_grad=True)
        tiles, aux = render_tiles(model, cam, rcfg,
                                  active_sh_degree=trainer.active_sh_degree,
                                  return_aux=True, mean2d_offset=probe)
        sync(cell.device)
        marks.append(time.perf_counter())
        loss, _ = fused_photometric_loss(tiles, target_chw, ntx, nty,
                                         rcfg.tile_size, h, w,
                                         tcfg.ssim_weight)
        sync(cell.device)
        marks.append(time.perf_counter())
        inputs = [getattr(model, n) for n in PARAM_NAMES] + [probe]
        grads = dict(zip(PARAM_NAMES + ("probe",),
                         torch.autograd.grad(loss, inputs)))
        sync(cell.device)
        marks.append(time.perf_counter())
        trainer.opt_state = trainer.tx.step(model, grads, trainer.opt_state)
        sync(cell.device)
        marks.append(time.perf_counter())
        trainer.dstate = densify.accumulate(trainer.dstate, grads["probe"],
                                            aux["visible"])
        sync(cell.device)
        marks.append(time.perf_counter())
        for name, a, b in zip(names, marks, marks[1:]):
            sums[name] += (b - a) * 1e3 / reps
    return sums


def _traced(cell, trainer, ref_cams, targets) -> Readings:
    from intro_to_gaussian_splatting_tpu_torch.ops import fused_loss
    from intro_to_gaussian_splatting_tpu_torch.ops import rasterize as R

    n = cell.params["trace_steps"]
    sync(cell.device)
    t0 = time.perf_counter()
    trainer.run(n)
    sync(cell.device)
    untraced_s = time.perf_counter() - t0
    expect = {"rasterize_fwd": lambda: R.RASTERIZE_FWD.launches,
              "rasterize_bwd": lambda: R.RASTERIZE_BWD.launches,
              "fused_loss": lambda: fused_loss.FUSED_LOSS.launches}
    trace, _ = tracing.traced_window(
        lambda: trainer.run(n), lambda: sync(cell.device), expect)
    cell.log(f"{n} steps: {untraced_s:.4f} s untraced, trace window "
             f"{trace.window_s:.4f} s")
    stage = _stage_ms(cell, trainer, trainer.cameras[0],
                      targets[0].permute(2, 0, 1).contiguous(),
                      cell.params["stage_reps"])
    model = trainer.model
    counts = sides.work_counts(
        cell, {k: getattr(model, k).detach() for k in NAMES},
        model.active, ref_cams, trainer.active_sh_degree)
    return Readings(trace=trace, units=n, untraced_s=untraced_s,
                    counts=counts, stage_ms=stage)


def _reference(cell, params, active, extent, ref_cams, targets,
               precision: str = "float32") -> dict:
    """The plain reference's checked steps from the initial state."""
    p = cell.params
    n = p["checked_steps"]
    tc = cell.config["train"]
    ref = RefTrainer(params, active, tc, extent, noise_seed=cell.seed)
    losses, first = [], None
    for i, cam_idx in enumerate(_order(cell, p["setup_steps"])[:n]):
        before = p["first_step"] - 1 + i
        degree = min(cell.config["sh_degree"],
                     before // tc["sh_degree_interval"])
        loss, grads = ref.step(ref_cams[cam_idx],
                               targets[cam_idx].permute(2, 0, 1),
                               cell.rasterizer(), degree, before + 1,
                               precision)
        losses.append(loss)
        first = grads if first is None else first
    return dict(losses=losses, grads=first, params=ref.p, active=ref.active)


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tensors.items()}


def compare(got: dict, want: dict, initial: dict, limits: dict) -> dict:
    """The numbers compared, each (value, limit): the worst step's loss
    gap, and per leaf the gap between the two sides' norms of the first
    gradient and of the parameters' change over the checked steps,
    against the reference's norm of the leaf or the median leaf's,
    whichever is larger; the slots whose active flag differs."""
    loss_gap = max(relative_gap(g, w, abs(w))
                   for g, w in zip(got["losses"], want["losses"]))
    g_got, g_want = _norms(got["grads"]), _norms(want["grads"])
    g_med = statistics.median(g_want.values())
    counted = [k for k in NAMES if g_want[k] >= NEGLIGIBLE_GRADIENT * g_med]
    grad_gap = max(relative_gap(g_got[k], g_want[k], max(g_want[k], g_med))
                   for k in counted)
    d_got = _norms({k: got["params"][k] - initial[k] for k in NAMES})
    d_want = _norms({k: want["params"][k] - initial[k] for k in NAMES})
    d_med = statistics.median(d_want[k] for k in counted)
    change_gap = max(relative_gap(d_got[k], d_want[k], max(d_want[k], d_med))
                     for k in counted)
    mismatch = int((got["active"] != want["active"]).sum())
    if len(got["losses"]) != len(want["losses"]):
        loss_gap = math.inf
    return dict(loss_gap=(loss_gap, limits["loss_gap"]),
                grad_gap=(grad_gap, limits["grad_gap"]),
                change_gap=(change_gap, limits["change_gap"]),
                active_mismatch=(mismatch, limits["active_mismatch"]))


def run(cell) -> Outcome:
    params, active, extent, poses, targets = _inputs(cell)
    trainer = _program(cell, params, active, extent, poses, targets)
    checked = _setup_run(trainer, cell.params["checked_steps"],
                         cell.params["setup_steps"])
    sync(cell.device)
    ref_cams = sides.reference_cameras(cell, poses)
    setup_s = time.perf_counter() - cell.t_start
    cell.log(f"set-up {setup_s:.2f} s")
    readings, e2e, attempted, failed = None, {}, 0, checked["overflow"]
    if cell.trace:
        readings = _traced(cell, trainer, ref_cams, targets)
        attempted = readings.units
    else:
        steps, seconds, rows = _window(cell, trainer)
        e2e["train_step_ms"] = seconds * 1e3 / steps
        attempted = steps
        failed += sum(1 for r in rows if not math.isfinite(r["loss"]))
    failed += _overflowed(trainer) - checked["overflow"]
    e2e["setup_s"] = setup_s
    peak = (torch.cuda.max_memory_allocated(cell.device)
            if cell.device.type == "cuda" else 0)
    del trainer
    gc.collect()
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    cell.log(f"window closed at {t_ref - cell.t_start:.2f} s")
    want = _reference(cell, params, active, extent, ref_cams, targets)
    checks = compare(checked, want, params, cell.limits)
    cell.log(f"reference {time.perf_counter() - t_ref:.2f} s")
    return Outcome(end_to_end=e2e, attempted=attempted, failed=failed,
                   checks=checks, memory_peak=peak, readings=readings)


def control(cell) -> Outcome:
    """The reference in TF32 in the program's place."""
    params, active, extent, poses, targets = _inputs(cell)
    ref_cams = sides.reference_cameras(cell, poses)
    got = _reference(cell, params, active, extent, ref_cams, targets,
                     precision="tf32")
    want = _reference(cell, params, active, extent, ref_cams, targets)
    return Outcome(end_to_end={}, attempted=0, failed=0,
                   checks=compare(got, want, params, cell.limits))
