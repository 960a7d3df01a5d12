"""Multi-process smoke: the whole sharded train step across process
boundaries. Run one copy per rank:

    python -m intro_to_gaussian_splatting_tpu_torch.parallel.multihost_smoke \\
        <process_id> <num_processes> <coordinator host:port> [--cpu]

Each rank joins the world (NCCL on the card, gloo with ``--cpu``), builds
the global mesh (two gauss shards when the world size is even), loads only
its own strip rows of the target (``process_local_rows`` /
``globalize_target``) and runs three ``sharded_train_step``s (ring binning,
probe gradients, Adam). It prints one line,
``SMOKE pid=<i> losses=<l0>,<l1>,<l2> psnr=<p>``: every rank must print
the same numbers (the loss is all-reduced) and the losses must fall.
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    cpu = "--cpu" in argv
    pid, nproc, coordinator = (a for a in argv if a != "--cpu")
    pid, nproc = int(pid), int(nproc)

    import numpy as np
    import torch
    import torch.distributed as dist

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
    from intro_to_gaussian_splatting_tpu_torch.ops.rasterize import (
        render_tiled,
    )
    from intro_to_gaussian_splatting_tpu_torch.parallel.mesh import (
        GAUSS_AXIS,
    )
    from intro_to_gaussian_splatting_tpu_torch.parallel.multihost import (
        global_mesh, globalize_target, init_multihost, process_local_rows,
        put_global_tree,
    )
    from intro_to_gaussian_splatting_tpu_torch.parallel.sharded import (
        pad_rows, sharded_train_step, strip_layout,
    )
    from intro_to_gaussian_splatting_tpu_torch.train import densify as D
    from intro_to_gaussian_splatting_tpu_torch.train.trainer import (
        make_optimizer,
    )

    if cpu:
        torch.set_num_threads(1)
    device = init_multihost(coordinator, nproc, pid,
                            device="cpu" if cpu else None)
    try:
        assert dist.get_world_size() == nproc, dist.get_world_size()
        # a deterministic tiny scene, the same on every rank
        n, width, height = 64, 64, 64
        xyz, rgb = random_point_cloud(n, seed=7, extent=2.0)
        qvec, tvec = ring_cameras(1, width, height, radius=4.0, seed=7)[0]
        cam = make_camera(0.9 * width, 0.9 * width, width, height, qvec,
                          tvec, device=device)
        rcfg = RasterizerConfig(pairs_per_gaussian=32, group_tiles=2)
        tcfg = TrainConfig(ssim_weight=0.0)
        true_model = init_from_points(xyz, rgb, scale_init=0.12, opacity=0.8,
                                      device=device)
        with torch.no_grad():
            target = render_tiled(true_model, cam, rcfg).cpu().numpy()

        mesh = global_mesh(n_gauss_shards=2 if nproc % 2 == 0 else None,
                           device=device)
        _, padded_h = strip_layout(height, rcfg.tile_size, mesh.size)
        row0, rows = process_local_rows(height, rcfg.tile_size, mesh)
        pad = pad_rows(torch.as_tensor(target), padded_h).numpy()
        target_strip = globalize_target(pad[row0:row0 + rows], padded_h,
                                        mesh)

        noise = np.random.default_rng(3).normal(size=(n, 1, 3))
        with torch.no_grad():
            true_model.sh += torch.as_tensor(0.25 * noise,
                                             dtype=torch.float32,
                                             device=device)
        model = put_global_tree(true_model, mesh, GAUSS_AXIS)
        tx = make_optimizer(tcfg, scene_extent=2.0)
        opt_state = tx.init({k: getattr(model, k) for k in PARAM_NAMES})
        dstate = D.DensifyState.zero(model.capacity, device)

        losses = []
        for _ in range(3):
            model, opt_state, dstate, metrics = sharded_train_step(
                model, opt_state, dstate, cam, target_strip, mesh, rcfg,
                tcfg, tx)
            losses.append(float(metrics["loss"]))
        psnr = float(metrics["psnr"])
        print(f"SMOKE pid={pid} losses="
              + ",".join(f"{v:.6f}" for v in losses) + f" psnr={psnr:.4f}",
              flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
