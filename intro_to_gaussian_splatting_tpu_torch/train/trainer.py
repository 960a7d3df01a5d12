"""3DGS optimization loop: Adam + densify/prune, one or B cameras per step.

The JAX package's train/trainer.py (``make_optimizer``, ``train_step``,
``train_step_batched``, ``Trainer``, ``scene_extent_of``) in PyTorch, for
one card:

  * ``make_optimizer`` gives optax's numbers: Adam (b1 0.9, b2 0.999, eps
    1e-15) per parameter group, the means' learning rate decaying
    exponentially from ``lr_means * extent`` to ``lr_means_final * extent``
    over ``iterations``, and the SH DC coefficient stepping at ``lr_sh0``
    while the rest step at ``lr_shN`` inside one tensor. That last split
    is why the update is a plain function on tensors in optax's order and
    not ``torch.optim.Adam``.
  * ``train_step`` renders in the rasterizer's tile layout (kernel B1,
    backward kernel B2) and takes the loss and its pixel gradient from
    kernel B3 (``fused_loss=True``, ``ssim_weight`` > 0, the default), from
    the split path (``fused_loss=False``: tile L1, the untile relayout B5,
    whose gradient is B5-tile, and the fused SSIM, kernels B4a and B4b) or
    from the plain tile L1 (``ssim_weight`` = 0), as the JAX package does.
    It differentiates a zero ``mean2d_offset`` probe for the screen-space
    gradients densification reads. Parameters are updated in place; dead
    slots keep theirs while their moments still update.
  * ``train_step_batched`` takes one Adam step on the mean gradient of B
    stacked same-resolution cameras, rendered and differentiated in order.
  * ``Trainer`` drives the loop: camera order (or camera-group order, with
    ``camera_batch`` > 1) from ``default_rng(seed)``, a byte-bounded LRU
    cache of targets on the card, a running count of pair-pool overflows
    kept on the card and read only at log and densify boundaries (doubling
    the pool when it grew), densify / prune / opacity reset, JSONL
    metrics, periodic full-state checkpoints and ``resume``.
  * ``train_cli`` is ``gstpu-torch train``: load a COLMAP scene with its
    photos, train, and write the checkpoint, the PLY and one render.

With ``mesh`` (parallel/mesh.py) the ``Trainer`` trains over a gauss x
tiles mesh of ranks, one per device: ``self.model`` is this rank's gauss
shard, every step a ``parallel.sharded.sharded_train_step`` on this
rank's strip of the target. Densify gathers the shards, runs the
single-card densify and prune identically on every rank and re-shards;
rank 0 writes checkpoints from the gathered state in the single-card
format, so a mesh checkpoint also resumes on one card.
``camera_batch`` > 1 raises under a mesh.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from intro_to_gaussian_splatting_tpu_torch.config import (
    RasterizerConfig,
    TrainConfig,
)
from intro_to_gaussian_splatting_tpu_torch.models.camera import (
    Camera,
    index_camera,
    stack_cameras,
)
from intro_to_gaussian_splatting_tpu_torch.models.gaussians import (
    PARAM_NAMES,
    GaussianModel,
)
from intro_to_gaussian_splatting_tpu_torch.ops.binning import tile_grid
from intro_to_gaussian_splatting_tpu_torch.ops.fused_loss import (
    fused_photometric_loss,
)
from intro_to_gaussian_splatting_tpu_torch.ops.rasterize import (
    image_to_tiles,
    render_tiles,
    tile_pixel_mask,
)
from intro_to_gaussian_splatting_tpu_torch.ops.relayout import (
    untile_chw_fast,
)
from intro_to_gaussian_splatting_tpu_torch.ops.ssim import fused_ssim
from intro_to_gaussian_splatting_tpu_torch.parallel import multihost, sharded
from intro_to_gaussian_splatting_tpu_torch.train import densify as D
from intro_to_gaussian_splatting_tpu_torch.train.loss import (
    psnr_from_mse,
    tile_l1,
    tile_psnr,
)
from intro_to_gaussian_splatting_tpu_torch.utils.profiling import span

ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-15


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AdamGroup:
    """optax's ``ScaleByAdamState`` of one parameter group; for the means
    also the step count of their learning-rate schedule."""

    count: torch.Tensor          # () int32
    mu: torch.Tensor
    nu: torch.Tensor
    schedule_count: Optional[torch.Tensor] = None


OptState = Dict[str, AdamGroup]


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """Per-group Adam with the 3DGS learning rates (``make_optimizer``)."""

    config: TrainConfig
    scene_extent: float

    def init(self, params: Dict[str, torch.Tensor]) -> OptState:
        def group(name, p):
            zero = torch.zeros((), dtype=torch.int32, device=p.device)
            return AdamGroup(
                count=zero, mu=torch.zeros_like(p), nu=torch.zeros_like(p),
                schedule_count=zero.clone() if name == "means" else None)
        return {name: group(name, params[name].detach())
                for name in PARAM_NAMES}

    def step_size(self, name: str, group: AdamGroup, like: torch.Tensor):
        """The signed step multiplying the Adam direction, as optax's
        ``scale`` / ``scale_by_schedule`` compute it."""
        c = self.config
        if name == "means":
            # exponential_decay at the pre-increment count
            count = group.schedule_count
            init = _f32(c.lr_means * self.scene_extent, like.device)
            rate = _f32(c.lr_means_final / c.lr_means, like.device)
            p = count.to(torch.float32) / float(c.iterations)
            lr = torch.where(count <= 0, init, init * torch.pow(rate, p))
            return -lr
        if name == "sh":
            k = like.shape[1]
            scale = torch.full((k,), -c.lr_shN, dtype=torch.float32,
                               device=like.device)
            scale[0] = -c.lr_sh0
            return scale[None, :, None]
        return -{"log_scales": c.lr_scales, "quats": c.lr_quats,
                 "opacity_logits": c.lr_opacity}[name]

    def update(self, grads: Dict[str, torch.Tensor], state: OptState):
        """(updates, new state) for ``grads``: optax's
        ``tx.update(grads, state)``, with every operation in its order."""
        updates, new_state = {}, {}
        for name in PARAM_NAMES:
            g, s = grads[name], state[name]
            mu = (1 - ADAM_B1) * g + ADAM_B1 * s.mu
            nu = (1 - ADAM_B2) * (g * g) + ADAM_B2 * s.nu
            count = s.count + 1
            t = count.to(torch.float32)
            mu_hat = mu / (1 - torch.pow(_f32(ADAM_B1, g.device), t))
            nu_hat = nu / (1 - torch.pow(_f32(ADAM_B2, g.device), t))
            direction = mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS)
            updates[name] = direction * self.step_size(name, s, g)
            new_state[name] = AdamGroup(
                count=count, mu=mu, nu=nu,
                schedule_count=(None if s.schedule_count is None
                                else s.schedule_count + 1))
        return updates, new_state

    @torch.no_grad()
    def step(self, model: GaussianModel, grads: Dict[str, torch.Tensor],
             state: OptState) -> OptState:
        """Apply one update to the model's parameters in place; dead slots
        keep their values (their moments still update)."""
        with span("optimizer"):
            updates, state = self.update(grads, state)
            for name in PARAM_NAMES:
                p = getattr(model, name)
                keep = model.active.reshape((-1,) + (1,) * (p.dim() - 1))
                p.copy_(torch.where(keep, p + updates[name], p))
        return state

    @staticmethod
    def moments(state: OptState):
        """Every per-slot tensor of the state (for ``zero_slots``)."""
        return [t for g in state.values() for t in (g.mu, g.nu)]


def _map_moments(state: OptState, fn) -> OptState:
    """``fn`` over the per-slot moments of every group; the step counts
    are the same for every slot and stay."""
    return {name: dataclasses.replace(g, mu=fn(g.mu), nu=fn(g.nu))
            for name, g in state.items()}


def make_optimizer(config: TrainConfig, scene_extent: float) -> Optimizer:
    """Per-parameter-group Adam with the 3DGS learning rates."""
    return Optimizer(config, float(scene_extent))


# ---------------------------------------------------------------------------
# One step
# ---------------------------------------------------------------------------

def camera_loss_and_grads(model: GaussianModel, camera: Camera,
                          target_tiles: Optional[torch.Tensor],
                          target_mask: Optional[torch.Tensor],
                          target_image: Optional[torch.Tensor],
                          rcfg: RasterizerConfig, tcfg: TrainConfig,
                          active_sh_degree: int = 0):
    """The photometric objective of one camera and its gradients:
    (loss, mse, tiles, aux, grads). ``grads`` holds one tensor per
    parameter and ``"probe"``, the (N, 2) screen-space gradient.

    Fused path (``fused_loss`` and ``ssim_weight`` > 0): ``target_image``
    is the (3, H, W) target, kernel B3 gives loss, MSE and pixel gradient.
    Split path: the tile L1 against ``target_tiles`` / ``target_mask`` and,
    with ``ssim_weight`` > 0, 1 - SSIM of the untiled colour channels
    against ``target_image`` (``mse`` is None).
    """
    h, w = camera.height, camera.width
    ts = rcfg.tile_size
    ntx, nty = tile_grid(w, h, ts)
    probe = torch.zeros((model.capacity, 2), dtype=torch.float32,
                        device=model.device, requires_grad=True)
    tiles, aux = render_tiles(model, camera, rcfg,
                              active_sh_degree=active_sh_degree,
                              return_aux=True, mean2d_offset=probe)
    wt = tcfg.ssim_weight
    if wt > 0.0 and tcfg.fused_loss:
        loss, mse = fused_photometric_loss(tiles, target_image, ntx, nty, ts,
                                           h, w, wt)
    else:
        loss, mse = tile_l1(tiles, target_tiles, target_mask), None
        if wt > 0.0:
            img = untile_chw_fast(tiles, ntx, nty, ts, h, w)
            loss = ((1.0 - wt) * loss
                    + wt * (1.0 - fused_ssim(img, target_image,
                                             grad_target=False)))
    inputs = [getattr(model, name) for name in PARAM_NAMES] + [probe]
    with span("backward"):
        grads = torch.autograd.grad(loss, inputs, allow_unused=True)
    grads = {name: torch.zeros_like(x) if g is None else g
             for name, x, g in zip(PARAM_NAMES + ("probe",), inputs, grads)}
    return loss.detach(), mse, tiles.detach(), aux, grads


def train_step(model: GaussianModel, opt_state: OptState,
               dstate: D.DensifyState, camera: Camera,
               target_tiles: Optional[torch.Tensor],
               target_mask: Optional[torch.Tensor],
               target_image: Optional[torch.Tensor],
               rcfg: RasterizerConfig, tcfg: TrainConfig, tx: Optimizer,
               active_sh_degree: int = 0):
    """One optimization step on one camera in the rasterizer's tile
    layout. Returns (model, opt_state, dstate, metrics); the model's
    parameters are updated in place. Metrics stay on the model's device."""
    loss, mse, tiles, aux, grads = camera_loss_and_grads(
        model, camera, target_tiles, target_mask, target_image, rcfg, tcfg,
        active_sh_degree)
    opt_state = tx.step(model, grads, opt_state)
    dstate = D.accumulate(dstate, grads["probe"], aux["visible"])
    metrics = dict(loss=loss,
                   psnr=_psnr(mse, tiles, target_tiles, target_mask),
                   num_active=model.active.sum(),
                   overflowed=aux["overflowed"])
    return model, opt_state, dstate, metrics


def _psnr(mse, tiles, target_tiles, target_mask):
    if mse is not None:
        return psnr_from_mse(mse)
    return tile_psnr(tiles, target_tiles, target_mask)


def train_step_batched(model: GaussianModel, opt_state: OptState,
                       dstate: D.DensifyState, cameras: Camera,
                       target_tiles: Optional[torch.Tensor],
                       target_mask: Optional[torch.Tensor],
                       target_images: Optional[torch.Tensor],
                       rcfg: RasterizerConfig, tcfg: TrainConfig,
                       tx: Optimizer, active_sh_degree: int = 0):
    """One optimization step on the mean gradient of B stacked
    same-resolution cameras (``stack_cameras``). The targets carry a
    leading B dimension in the layout the loss needs (see
    ``camera_loss_and_grads``; None where unused). The cameras are rendered
    and differentiated in order; their gradients are summed in that order
    and divided by B, and the densify statistics accumulate per camera, as
    B sequential steps would. Loss and PSNR are the means over the cameras,
    ``overflowed`` is true if any camera's pair pool overflowed."""
    b = cameras.world2view.shape[0]

    def pick(t, i):
        return None if t is None else t[i]

    gsum, loss_sum, psnr_sum, overflowed = None, 0.0, 0.0, False
    for i in range(b):
        tt, tm = pick(target_tiles, i), pick(target_mask, i)
        loss, mse, tiles, aux, grads = camera_loss_and_grads(
            model, index_camera(cameras, i), tt, tm, pick(target_images, i),
            rcfg, tcfg, active_sh_degree)
        dstate = D.accumulate(dstate, grads.pop("probe"), aux["visible"])
        gsum = grads if gsum is None else {
            name: gsum[name] + g for name, g in grads.items()}
        loss_sum = loss_sum + loss
        psnr_sum = psnr_sum + _psnr(mse, tiles, tt, tm)
        overflowed = overflowed | aux["overflowed"]
    opt_state = tx.step(model, {name: g / b for name, g in gsum.items()},
                        opt_state)
    metrics = dict(loss=loss_sum / b, psnr=psnr_sum / b,
                   num_active=model.active.sum(), overflowed=overflowed)
    return model, opt_state, dstate, metrics


# ---------------------------------------------------------------------------
# The loop
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Trainer:
    """Drives the loop on the model's device; holds the host-side state
    (step counter, camera order, the generator of the split noise). With
    ``tcfg.camera_batch`` > 1 every step is a ``train_step_batched`` over a
    fixed group of consecutive cameras; the last group wraps around when
    the batch does not divide the camera count."""

    model: GaussianModel
    cameras: list            # list[Camera]
    targets: list            # list of (H, W, 3) arrays or tensors
    scene_extent: float
    rcfg: RasterizerConfig = RasterizerConfig()
    tcfg: TrainConfig = TrainConfig()
    log_every: int = 50
    on_log: Optional[Callable] = None
    # a parallel.mesh.Mesh: train this rank's shard over the mesh
    mesh: Optional[object] = None
    ring: bool = True                 # the mesh's record routing
    # with tcfg.checkpoint_every > 0, the full state (model, optimizer,
    # step) is saved here every that many steps; resume() restores it
    checkpoint_dir: Optional[str] = None
    # one JSON object per logged metrics row
    jsonl_path: Optional[str] = None
    # device-memory budget for the cached targets, LRU-evicted beyond it
    target_cache_bytes: int = 4 << 30

    def __post_init__(self):
        if self.mesh is not None:
            self._setup_sharded()
        self.device = self.model.device
        self.tx = make_optimizer(self.tcfg, self.scene_extent)
        self.opt_state = self.tx.init(
            {name: getattr(self.model, name) for name in PARAM_NAMES})
        self.dstate = D.DensifyState.zero(self.model.capacity, self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(
            self.tcfg.seed)
        self.step = 0
        self.history = []
        # cam_idx or ("batch", *group) -> (entry, nbytes), least recently
        # used first
        self._tiled = collections.OrderedDict()
        self._tiled_bytes = 0
        self._masks = {}     # (H, W) -> tile_pixel_mask
        # steps whose pair pool overflowed, counted on the card and read
        # only at log and densify boundaries
        self._overflow_count = torch.zeros((), dtype=torch.int32,
                                           device=self.device)
        self._overflow_seen = 0

    # ---- mesh plumbing -------------------------------------------------
    def _setup_sharded(self):
        if self.tcfg.camera_batch > 1:
            raise ValueError(
                "camera_batch > 1 is not supported over a device mesh: "
                "train one camera per step (camera_batch=1)")
        self.model = sharded.shard_model(self.model, self.mesh)
        self.cameras = [sharded.camera_on(c, self.mesh.device)
                        for c in self.cameras]

    def gathered_model(self) -> GaussianModel:
        """The whole model: gathered from every rank's shard under a mesh
        (every rank must call it), ``self.model`` otherwise."""
        if self.mesh is None:
            return self.model
        return multihost.gather_model(self.model, self.mesh)

    def _gathered_state(self):
        """(whole model, whole optimizer state) from every rank's shard."""
        return self.gathered_model(), _map_moments(
            self.opt_state, lambda t: multihost.gather_rows(t, self.mesh))

    def _take_shards(self, model: GaussianModel, opt_state: OptState):
        """This rank's shard of a whole model and optimizer state."""
        self.model = sharded.shard_model(model, self.mesh)
        self.opt_state = _map_moments(
            opt_state, lambda t: sharded.shard_rows(t, self.mesh).clone())

    def _sharded_target_for(self, cam_idx: int) -> torch.Tensor:
        """This rank's (strip_rows, W, 3) rows of a camera's target, zero
        past the image, LRU-cached on the device. Only those rows are
        copied to the device."""
        entry = self._cache_get(cam_idx)
        if entry is None:
            cam = self.cameras[cam_idx]
            row0, rows = multihost.process_local_rows(
                cam.height, self.rcfg.tile_size, self.mesh)
            local = torch.as_tensor(self.targets[cam_idx][row0:row0 + rows],
                                    dtype=torch.float32)
            entry = sharded.pad_rows(local.to(self.device), rows).contiguous()
            self._cache_put(cam_idx, entry, self._nbytes((entry,)))
        return entry

    # ---- bounded target cache ------------------------------------------
    def _cache_get(self, cam_idx: int):
        if cam_idx not in self._tiled:
            return None
        self._tiled.move_to_end(cam_idx)
        return self._tiled[cam_idx][0]

    def _cache_put(self, cam_idx: int, entry, nbytes: int):
        self._tiled[cam_idx] = (entry, nbytes)
        self._tiled_bytes += nbytes
        while (self._tiled_bytes > self.target_cache_bytes
               and len(self._tiled) > 1):
            old_key, (_, old_bytes) = self._tiled.popitem(last=False)
            if old_key == cam_idx:      # never evict the entry just added
                self._tiled[old_key] = (entry, nbytes)
                break
            self._tiled_bytes -= old_bytes
        return entry

    @property
    def _fused(self) -> bool:
        return self.tcfg.ssim_weight > 0.0 and self.tcfg.fused_loss

    def _target(self, cam_idx: int) -> torch.Tensor:
        return torch.as_tensor(self.targets[cam_idx], dtype=torch.float32,
                               device=self.device)

    def _mask(self, h: int, w: int) -> torch.Tensor:
        if (h, w) not in self._masks:
            self._masks[(h, w)] = tile_pixel_mask(h, w, self.rcfg,
                                                  self.device)
        return self._masks[(h, w)]

    def _layouts(self, target: torch.Tensor):
        """(tiles, image) of an (H, W, 3) target in the layouts its loss
        needs, None where unused: the (3, H, W) image alone for the fused
        loss; the tiles, and the image when SSIM is on, for the split
        path."""
        chw = (target.permute(2, 0, 1).contiguous()
               if self.tcfg.ssim_weight > 0.0 else None)
        if self._fused:
            return None, chw
        return image_to_tiles(target, self.rcfg), chw

    @staticmethod
    def _nbytes(entry) -> int:
        return sum(t.numel() * t.element_size() for t in entry
                   if isinstance(t, torch.Tensor))

    def _target_for(self, cam_idx: int):
        """(target_tiles, target_mask, target_image) of one camera, None
        where its loss needs none, LRU-cached on the device."""
        cam = self.cameras[cam_idx]
        entry = self._cache_get(cam_idx)
        if entry is None:
            entry = self._layouts(self._target(cam_idx))
            self._cache_put(cam_idx, entry, self._nbytes(entry))
        tiles, img = entry
        if tiles is None:
            return None, None, img
        return tiles, self._mask(cam.height, cam.width), img

    def _batched_target_for(self, group):
        """Stacked cameras and targets (tiles, masks, images; None where
        unused) of one fixed camera group, LRU-cached on the device."""
        key = ("batch",) + tuple(group)
        entry = self._cache_get(key)
        if entry is None:
            cams = stack_cameras([self.cameras[i] for i in group])
            tiles, imgs = zip(*(self._layouts(self._target(i))
                                for i in group))
            masks = None
            if tiles[0] is not None:
                mask = self._mask(cams.height, cams.width)
                masks = mask.expand((len(group),) + tuple(mask.shape))
                tiles = torch.stack(tiles)
            else:
                tiles = None
            imgs = None if imgs[0] is None else torch.stack(imgs)
            entry = (cams, tiles, masks, imgs)
            self._cache_put(key, entry, self._nbytes((tiles, imgs)))
        return entry

    @property
    def active_sh_degree(self) -> int:
        if self.model.color_space != "sh":
            return 0
        return min(self.model.sh_degree,
                   self.step // self.tcfg.sh_degree_interval)

    def _train_unit(self, unit: int) -> dict:
        """One optimization step on camera ``unit`` (camera group ``unit``
        with ``camera_batch`` > 1); returns its metrics."""
        if self.mesh is not None:
            self.model, self.opt_state, self.dstate, metrics = \
                sharded.sharded_train_step(
                    self.model, self.opt_state, self.dstate,
                    self.cameras[unit], self._sharded_target_for(unit),
                    self.mesh, self.rcfg, self.tcfg, self.tx,
                    self.active_sh_degree, ring=self.ring)
            return metrics
        bsz = self.tcfg.camera_batch
        if bsz > 1:
            n_cams = len(self.cameras)
            group = tuple((unit * bsz + k) % n_cams for k in range(bsz))
            camera, tt, tm, ti = self._batched_target_for(group)
            step = train_step_batched
        else:
            tt, tm, ti = self._target_for(unit)
            step, camera = train_step, self.cameras[unit]
        self.model, self.opt_state, self.dstate, metrics = step(
            self.model, self.opt_state, self.dstate, camera, tt, tm, ti,
            self.rcfg, self.tcfg, self.tx, self.active_sh_degree)
        return metrics

    def run(self, iterations: Optional[int] = None):
        iterations = iterations or self.tcfg.iterations
        bsz = self.tcfg.camera_batch
        n_cams = len(self.cameras)
        n_units = max(1, -(-n_cams // bsz)) if bsz > 1 else n_cams
        order = np.random.default_rng(self.tcfg.seed).permutation(
            np.arange(iterations) % n_units)
        t0 = time.time()
        for it in range(iterations):
            with span("step"):
                metrics = self._train_unit(int(order[it]))
                self.step += 1
                self._overflow_count += metrics["overflowed"].to(torch.int32)
                self._maybe_densify()
                self._maybe_checkpoint()
                if self.step % self.log_every == 0 or it == iterations - 1:
                    m = dict(metrics, overflow_steps=self._overflow_count)
                    m = self._fetch_metrics(m)
                    # steps since the last boundary whose pool overflowed
                    total = int(m.pop("overflow_steps"))
                    m["overflow_steps"] = total - self._overflow_seen
                    self._overflow_seen = total
                    m.update(step=self.step, sec=round(time.time() - t0, 2))
                    self.history.append(m)
                    if self.jsonl_path:
                        with open(self.jsonl_path, "a") as f:
                            f.write(json.dumps(m) + "\n")
                    if self.on_log:
                        self.on_log(m)
                    if m["overflow_steps"] > 0:
                        self._grow_pair_pool()
        return self.history

    @staticmethod
    def _fetch_metrics(metrics: dict) -> dict:
        """Device scalars -> host floats in one transfer."""
        keys = list(metrics)
        values = torch.stack([torch.as_tensor(metrics[k]).to(torch.float64)
                              for k in keys]).tolist()
        return dict(zip(keys, values))

    def _maybe_checkpoint(self):
        """Periodic full-state save (model, optimizer moments, step), the
        newest ``tcfg.checkpoint_keep`` kept."""
        every = self.tcfg.checkpoint_every
        if not (every and self.checkpoint_dir and self.step % every == 0):
            return
        from intro_to_gaussian_splatting_tpu_torch.train.checkpoint import (
            prune_checkpoints,
        )
        self.save_checkpoint(self.checkpoint_dir)
        if self._is_coordinator:
            prune_checkpoints(self.checkpoint_dir, self.tcfg.checkpoint_keep)
        if self.on_log:
            self.on_log(dict(step=self.step, event="checkpoint_saved",
                             dir=self.checkpoint_dir))

    @property
    def _is_coordinator(self) -> bool:
        return self.mesh is None or self.mesh.rank == 0

    def save_checkpoint(self, path: str) -> None:
        """Save the full state at this step under ``path``. Under a mesh
        every rank must call it: the state is gathered, rank 0 writes the
        single-card format, and all ranks wait for the write."""
        from intro_to_gaussian_splatting_tpu_torch.train.checkpoint import (
            save_checkpoint,
        )
        if self.mesh is None:
            save_checkpoint(path, self.model, self.opt_state, self.step)
            return
        model, opt_state = self._gathered_state()
        if self._is_coordinator:
            save_checkpoint(path, model, opt_state, self.step)
        multihost.barrier()

    def resume(self, path: Optional[str] = None,
               step: Optional[int] = None) -> int:
        """Restore model, optimizer and step from the newest (or the given)
        checkpoint; returns the restored step. The Trainer must be built
        with the same scene and capacity as the run that saved it. As in
        the JAX package, the densify statistics start from zero, the split
        noise's generator from the seed and ``run`` draws the remaining
        steps' camera order anew: a resumed run on one camera equals the
        uninterrupted one bit for bit until its first densify step."""
        from intro_to_gaussian_splatting_tpu_torch.train.checkpoint import (
            load_checkpoint,
        )
        path = path or self.checkpoint_dir
        if not path:
            raise ValueError("resume() needs a checkpoint path")
        if self.mesh is None:
            self.model, self.opt_state, self.step = load_checkpoint(
                path, self.model, self.opt_state, step)
            return self.step
        # every rank reads the same step whole and takes its shard
        model, opt_state = self._gathered_state()
        model, opt_state, self.step = load_checkpoint(path, model, opt_state,
                                                      step)
        self._take_shards(model, opt_state)
        return self.step

    def _grow_pair_pool(self):
        """The pair pool dropped whole far gaussians: double it so the drop
        is a transient, not a steady state."""
        self.rcfg = dataclasses.replace(
            self.rcfg, pairs_per_gaussian=self.rcfg.pairs_per_gaussian * 2)
        if self.on_log:
            self.on_log(dict(step=self.step, event="pair_pool_grown",
                             pairs_per_gaussian=self.rcfg.pairs_per_gaussian))

    def _densify_and_prune(self, model: GaussianModel,
                           dstate: D.DensifyState) -> torch.Tensor:
        """Densify and prune the whole ``model`` in place; returns the
        slots written (``densify``'s)."""
        max_new = max(model.capacity // 8, 1)
        noise = D.split_noise(max_new, self.generator, self.device)
        slots = D.densify(model, dstate, noise, self.tcfg, self.scene_extent,
                          max_new)
        D.prune(model, self.tcfg, self.scene_extent)
        return slots

    def _densify_on_mesh(self):
        """Gather the shards and densify statistics, densify and prune the
        whole model identically on every rank (the same seed and device
        type give the same noise and the same bits), take this rank's shard
        again and zero the moments of its new slots."""
        model = self.gathered_model()
        dstate = D.DensifyState(
            grad_accum=multihost.gather_rows(self.dstate.grad_accum,
                                             self.mesh),
            count=multihost.gather_rows(self.dstate.count, self.mesh))
        slots = self._densify_and_prune(model, dstate)
        self.model = sharded.shard_model(model, self.mesh)
        cap = self.model.capacity
        local = slots - self.mesh.g_idx * cap
        local = torch.where((local >= 0) & (local < cap), local, cap)
        D.zero_slots(Optimizer.moments(self.opt_state), local, cap)

    def _maybe_densify(self):
        t = self.tcfg
        if (t.densify_start <= self.step <= t.densify_stop
                and self.step % t.densify_interval == 0):
            # densification grows pair demand: grow a truncating pool at
            # most one interval after it starts dropping
            total = int(self._overflow_count.item())
            if total > self._overflow_seen:
                self._overflow_seen = total
                self._grow_pair_pool()
            if self.mesh is None:
                slots = self._densify_and_prune(self.model, self.dstate)
                D.zero_slots(Optimizer.moments(self.opt_state), slots,
                             self.model.capacity)
            else:
                self._densify_on_mesh()
            self.dstate = D.DensifyState.zero(self.model.capacity,
                                              self.device)
        if (t.opacity_reset_interval and self.step > 0
                and self.step % t.opacity_reset_interval == 0):
            D.reset_opacity(self.model)


def scene_extent_of(points: np.ndarray) -> float:
    """Radius of the point cloud's bounding sphere about its mean (3DGS
    uses the camera extent; the point extent stands in)."""
    center = points.mean(axis=0)
    return float(np.linalg.norm(points - center, axis=1).max())


# ---------------------------------------------------------------------------
# CLI entry (gstpu-torch train)
# ---------------------------------------------------------------------------

def train_cli(args) -> int:
    """Train a COLMAP scene with its photos (``args`` from the ``train``
    subcommand of ``cli.py``) on the card, or on the CPU with ``--cpu``.
    Writes ``<out-dir>/ckpt/step_<N>``, ``point_cloud.ply``, ``render.ppm``
    and ``metrics.jsonl``; ``--iterations`` is the total budget, also when
    resuming.

    With ``--multihost`` this process is one rank of a gauss x tiles mesh
    over every process (NCCL on the card, gloo with ``--cpu``): the
    capacity is rounded up to a multiple of the gauss axis, and only rank
    0 prints the log and writes the files, from the gathered model."""
    import torch.distributed as dist

    from intro_to_gaussian_splatting_tpu_torch.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    if not args.multihost:
        return _train_cli(args, device, None)
    owned = not dist.is_initialized()
    device = multihost.init_multihost(args.coordinator, args.num_processes,
                                      args.process_id, device)
    try:
        mesh = multihost.global_mesh(device=device)
        print(f"multihost: rank {mesh.rank} of {mesh.size}, mesh "
              f"{mesh.shape}, device={device}")
        return _train_cli(args, device, mesh)
    finally:
        if owned:
            dist.destroy_process_group()


def _train_cli(args, device, mesh) -> int:
    from intro_to_gaussian_splatting_tpu_torch.cli import write_ppm
    from intro_to_gaussian_splatting_tpu_torch.io.dataset import load_scene
    from intro_to_gaussian_splatting_tpu_torch.models import init_from_points
    from intro_to_gaussian_splatting_tpu_torch.ops.rasterize import (
        render_tiled,
    )
    from intro_to_gaussian_splatting_tpu_torch.train.checkpoint import (
        export_ply,
    )

    scene = load_scene(args.scene, downscale=args.downscale,
                       min_track=args.min_track, device=device)
    if not scene.targets:
        raise SystemExit(
            f"no ground-truth images found under {args.scene}/images")
    train_scene, holdout_scene = scene.split_holdout(args.holdout)
    points = scene.points
    cams, targets = train_scene.cameras, train_scene.targets

    tcfg = TrainConfig(iterations=args.iterations)
    if args.ssim_weight is not None:
        tcfg = dataclasses.replace(tcfg, ssim_weight=args.ssim_weight)
    if args.camera_batch > 1:
        tcfg = dataclasses.replace(tcfg, camera_batch=args.camera_batch)
    if args.checkpoint_every:
        tcfg = dataclasses.replace(tcfg,
                                   checkpoint_every=args.checkpoint_every)

    capacity = int(len(points) * tcfg.capacity_multiplier)
    if mesh is not None:
        capacity = -(-capacity // mesh.n_gauss) * mesh.n_gauss
    model = init_from_points(
        points.xyz, points.rgb, sh_degree=tcfg.sh_degree, color_space="sh",
        capacity=capacity, opacity=0.1, scale_init=None, device=device)
    # one rank prints and writes for the mesh
    coordinator = mesh is None or mesh.rank == 0
    say = print if coordinator else (lambda *a, **k: None)
    say(f"training {len(cams)} views, {len(points)} points on "
        f"device={device}")

    def log(m):
        if "event" in m:
            say(f"step {m['step']}: {m['event']} ({m})")
            return
        say(f"step {m['step']}: loss {m['loss']:.4f} "
            f"psnr {m['psnr']:.2f} active {int(m['num_active'])}")

    os.makedirs(args.out_dir, exist_ok=True)
    ckpt_dir = os.path.join(args.out_dir, "ckpt")
    trainer = Trainer(model=model, cameras=cams, targets=targets,
                      scene_extent=scene_extent_of(points.xyz), tcfg=tcfg,
                      on_log=log,
                      log_every=max(1, min(50, args.iterations // 6)),
                      mesh=mesh, checkpoint_dir=ckpt_dir,
                      jsonl_path=(os.path.join(args.out_dir, "metrics.jsonl")
                                  if coordinator else None))
    iterations = args.iterations
    if args.resume:
        restored = trainer.resume(
            ckpt_dir if args.resume == "auto" else args.resume)
        iterations = max(0, args.iterations - restored)
        say(f"resumed from step {restored} "
            f"({iterations} iterations remaining)")
    if iterations:
        trainer.run(iterations)

    trainer.save_checkpoint(ckpt_dir)
    final = trainer.gathered_model()
    if not coordinator:
        return 0
    export_ply(os.path.join(args.out_dir, "point_cloud.ply"), final)
    with torch.no_grad():
        img = render_tiled(final, cams[0], trainer.rcfg,
                           active_sh_degree=trainer.active_sh_degree)
    write_ppm(os.path.join(args.out_dir, "render.ppm"), img.cpu().numpy())
    print(f"saved checkpoint + ply + render to {args.out_dir}")

    if args.eval_at_end:
        from intro_to_gaussian_splatting_tpu_torch.train.evaluate import (
            evaluate,
        )
        es = holdout_scene if holdout_scene.cameras else train_scene
        tag = "holdout" if holdout_scene.cameras else "train"
        rows = evaluate(final, es.cameras, es.targets, trainer.rcfg,
                        active_sh_degree=trainer.active_sh_degree,
                        names=es.names)
        for r in rows:
            print(f"eval[{tag}] {r['name']:>20s}  psnr {r['psnr']:6.2f}  "
                  f"ssim {r['ssim']:.4f}")
    return 0
