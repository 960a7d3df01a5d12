"""Training steps in plain PyTorch: the 3DGS loop's step, its Adam and its
densify-and-prune, as the configuration states them.

Adam (b1 0.9, b2 0.999, eps 1e-15) per parameter group with the 3DGS
learning rates: the means' decays exponentially from ``lr_means * extent``
to ``lr_means_final * extent`` over ``iterations`` steps of its own count;
the first SH coefficient steps at ``lr_sh0`` and the rest at ``lr_shN``.
Inactive slots keep their values. Densification (every
``densify_interval`` steps inside [densify_start, densify_stop]) copies the
active gaussians whose mean screen-space gradient passes the threshold,
highest first, into the lowest free slots, splitting (offset by a sample
of the source, both shrunk by 1.6) those larger than
``densify_scale_threshold * extent``; pruning then deactivates the
gaussians fainter than ``prune_opacity_threshold`` or larger than half the
extent.
"""

from __future__ import annotations

import math

import torch

from gsbench.reference.projection import rotations
from gsbench.reference.render import loss_and_grads

NAMES = ("means", "log_scales", "quats", "opacity_logits", "sh")


class RefTrainer:
    def __init__(self, params: dict, active: torch.Tensor, tcfg: dict,
                 extent: float, noise_seed: int):
        self.p = {k: params[k].detach().clone() for k in NAMES}
        self.active = active.clone()
        self.c = tcfg
        self.extent = extent
        n = self.active.shape[0]
        dev = self.active.device
        self.mu = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.count = 0
        self.grad_accum = torch.zeros(n, device=dev)
        self.visible_count = torch.zeros(n, dtype=torch.int32, device=dev)
        self.generator = torch.Generator(device=dev).manual_seed(noise_seed)

    def _lr(self, name: str, like: torch.Tensor):
        c = self.c
        if name == "means":
            init = c["lr_means"] * self.extent
            rate = c["lr_means_final"] / c["lr_means"]
            return init * rate ** (self.count / c["iterations"])
        if name == "sh":
            lr = torch.full((like.shape[1],), c["lr_shN"], device=like.device)
            lr[0] = c["lr_sh0"]
            return lr[None, :, None]
        return c[{"log_scales": "lr_scales", "quats": "lr_quats",
                  "opacity_logits": "lr_opacity"}[name]]

    @torch.no_grad()
    def adam(self, grads: dict):
        t = self.count + 1
        for k in NAMES:
            g = grads[k]
            self.mu[k] = 0.1 * g + 0.9 * self.mu[k]
            self.nu[k] = 0.001 * g * g + 0.999 * self.nu[k]
            mu_hat = self.mu[k] / (1 - 0.9 ** t)
            nu_hat = self.nu[k] / (1 - 0.999 ** t)
            step = self._lr(k, g) * mu_hat / (torch.sqrt(nu_hat) + 1e-15)
            keep = self.active.reshape((-1,) + (1,) * (g.dim() - 1))
            self.p[k] = torch.where(keep, self.p[k] - step, self.p[k])
        self.count = t

    def step(self, cam, target_chw, rast: dict, sh_degree: int,
             step_number: int, precision: str = "float32"):
        """One step numbered ``step_number`` (the loop's count after it);
        returns (loss, grads)."""
        loss, grads, screen, visible = loss_and_grads(
            self.p, self.active, cam, target_chw, rast,
            self.c["ssim_weight"], sh_degree, precision)
        self.adam(grads)
        norm = torch.sqrt(torch.sum(screen * screen, dim=-1))
        self.grad_accum += torch.where(visible, norm, 0.0)
        self.visible_count += visible.to(torch.int32)
        c = self.c
        if (c["densify_start"] <= step_number <= c["densify_stop"]
                and step_number % c["densify_interval"] == 0):
            self.densify_and_prune()
            self.grad_accum.zero_()
            self.visible_count.zero_()
        if (c["opacity_reset_interval"]
                and step_number % c["opacity_reset_interval"] == 0):
            ceiling = math.log(0.01 / 0.99)
            self.p["opacity_logits"].clamp_(max=ceiling)
        return loss, grads

    @torch.no_grad()
    def densify_and_prune(self):
        c, p, active = self.c, self.p, self.active
        n = active.shape[0]
        max_new = max(n // 8, 1)
        noise = torch.randn((max_new, 3), generator=self.generator,
                            device=active.device)
        grad_avg = self.grad_accum / torch.clamp(self.visible_count, min=1)
        cand = active & (grad_avg > c["densify_grad_threshold"])
        big = torch.exp(p["log_scales"].max(dim=-1).values) > (
            c["densify_scale_threshold"] * self.extent)
        split = cand & big
        score = torch.where(cand, grad_avg, -math.inf)
        src = torch.argsort(-score, stable=True)[:max_new]
        free = torch.argsort(active.to(torch.int8), stable=True)[:max_new]
        ok = (score[src] > -math.inf) & ~active[free]
        src, dst = src[ok], free[ok]
        shrink = math.log(1.6)
        s_split = split[src][:, None]
        offset = torch.einsum(
            "nij,nj->ni", rotations(p["quats"][src]),
            noise[:ok.shape[0]][ok] * torch.exp(p["log_scales"][src]))
        new = dict(means=p["means"][src] + torch.where(s_split, offset, 0.0),
                   log_scales=p["log_scales"][src]
                   - torch.where(s_split, shrink, 0.0),
                   quats=p["quats"][src],
                   opacity_logits=p["opacity_logits"][src], sh=p["sh"][src])
        for k in NAMES:
            p[k][dst] = new[k]
        active[dst] = True
        p["log_scales"] -= torch.where(split[:, None], shrink, 0.0)
        faint = torch.sigmoid(p["opacity_logits"]) < c[
            "prune_opacity_threshold"]
        huge = torch.exp(p["log_scales"].max(dim=-1).values) > (
            0.5 * self.extent)
        active &= ~faint & ~huge
