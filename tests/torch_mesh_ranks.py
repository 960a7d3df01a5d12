"""Worlds of ranks for the port's mesh tests: ``start_world`` starts one
OS process per rank, each running this module's ``main`` on the CPU over
gloo, and ``wait_world`` gathers every rank's results as numpy.

A rank joins the world, builds the default mesh (1 rank: 1x1; 4 ranks:
2x2), runs every case of the pickled dict it is given, in order, and
writes its results under ``rank<r>.pkl``. Cases hold only numpy arrays,
ints, floats and strings. This module imports no JAX, so a rank starts in
about a second.
"""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_world(world: int, cases: dict, tmp: Path):
    """Start ``world`` rank processes on ``cases``; returns a handle for
    ``wait_world``."""
    tmp.mkdir(parents=True, exist_ok=True)
    case_path = tmp / "cases.pkl"
    with open(case_path, "wb") as f:
        pickle.dump(cases, f)
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_mesh_ranks", str(r), str(world),
         str(port), str(case_path), str(tmp)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    return procs, tmp


def wait_world(handle, timeout: float = 240.0) -> list:
    """Every rank's results, rank order; kills the whole world if one rank
    fails or the world outlasts ``timeout`` seconds."""
    procs, tmp = handle
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
    results = []
    for r in range(len(procs)):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


# ---------------------------------------------------------------------------
# The rank side
# ---------------------------------------------------------------------------

def _np(t):
    return t.detach().cpu().numpy()


def _model(spec):
    from intro_to_gaussian_splatting_tpu_torch import convert
    return convert.model_from_numpy(spec["params"], spec["active"],
                                    spec["color_space"], device="cpu")


def _camera(spec):
    from intro_to_gaussian_splatting_tpu_torch import convert
    return convert.camera_from_numpy(spec, device="cpu")


def _rcfg(spec):
    from intro_to_gaussian_splatting_tpu_torch.config import (
        CompatConfig, RasterizerConfig,
    )
    spec = dict(spec)
    compat = CompatConfig(**spec.pop("compat", {}))
    return RasterizerConfig(**spec, compat=compat)


def _model_arrays(model):
    from intro_to_gaussian_splatting_tpu_torch.models.gaussians import (
        PARAM_NAMES,
    )
    out = {n: _np(getattr(model, n)) for n in PARAM_NAMES}
    out["active"] = _np(model.active)
    return out


def case_render(mesh, spec, tmp):
    from intro_to_gaussian_splatting_tpu_torch.parallel import sharded as S
    img = S.sharded_render(S.shard_model(_model(spec["model"]), mesh),
                           _camera(spec["camera"]), mesh,
                           _rcfg(spec["rcfg"]), ring=spec["ring"])
    return dict(image=_np(img))


def _target_strip(target, height, rcfg, mesh):
    import torch

    from intro_to_gaussian_splatting_tpu_torch.parallel.multihost import (
        process_local_rows,
    )
    from intro_to_gaussian_splatting_tpu_torch.parallel.sharded import (
        pad_rows,
    )
    row0, rows = process_local_rows(height, rcfg.tile_size, mesh)
    local = torch.as_tensor(target[row0:row0 + rows], dtype=torch.float32)
    return pad_rows(local, rows)


def case_loss_grads(mesh, spec, tmp):
    from intro_to_gaussian_splatting_tpu_torch.parallel import sharded as S
    from intro_to_gaussian_splatting_tpu_torch.parallel.multihost import (
        gather_rows,
    )
    cam, rcfg = _camera(spec["camera"]), _rcfg(spec["rcfg"])
    loss, grads, aux = S.sharded_loss_and_grads(
        S.shard_model(_model(spec["model"]), mesh), cam,
        _target_strip(spec["target"], cam.height, rcfg, mesh), mesh, rcfg,
        spec["ssim_weight"], ring=spec["ring"])
    out = {f"grad_{k}": _np(gather_rows(g, mesh)) for k, g in grads.items()}
    out.update({k: _np(aux[k]) for k in ("overflowed", "ring_demand",
                                         "ring_emitted",
                                         "ring_bytes_per_device")})
    out["loss"] = _np(loss)
    return out


def case_far_tail(mesh, spec, tmp):
    import torch
    import torch.distributed as dist

    from intro_to_gaussian_splatting_tpu_torch.parallel import sharded as S
    cam, rcfg = _camera(spec["camera"]), _rcfg(spec["rcfg"])
    strip_rows, _ = S.strip_layout(cam.height, rcfg.tile_size, mesh.size)
    with torch.no_grad():
        strip, pairs, _ = S._render_strip(
            S.shard_model(_model(spec["model"]), mesh), cam, rcfg,
            strip_rows, mesh, ring=True,
            max_pairs_local=spec["max_pairs_local"])
    parts = [torch.empty_like(strip) for _ in range(mesh.size)]
    dist.all_gather(parts, strip.contiguous())
    flags = [torch.zeros(1) for _ in range(mesh.size)]
    dist.all_gather(flags, pairs.overflowed.to(torch.float32).reshape(1))
    return dict(image=_np(torch.cat(parts)[:cam.height, :, :3]),
                overflowed=_np(torch.cat(flags)) > 0.5)


def _trainer(mesh, spec, **kw):
    from intro_to_gaussian_splatting_tpu_torch.config import TrainConfig
    from intro_to_gaussian_splatting_tpu_torch.train.trainer import Trainer
    return Trainer(model=_model(spec["model"]),
                   cameras=[_camera(spec["camera"])],
                   targets=[spec["target"]], scene_extent=1.0,
                   rcfg=_rcfg(spec["rcfg"]),
                   tcfg=TrainConfig(**spec["tcfg"]), log_every=2, mesh=mesh,
                   **kw)


def case_trainer(mesh, spec, tmp):
    trainer = _trainer(mesh, spec)
    history = trainer.run(spec["steps"])
    return dict(history=history, gathered=_model_arrays(
        trainer.gathered_model()), shard=_model_arrays(trainer.model),
        adam_mu={n: _np(g.mu) for n, g in trainer.opt_state.items()})


def case_resume(mesh, spec, tmp):
    """A straight run of ``steps`` and one resumed from ``resume_at``
    (saved every ``checkpoint_every`` steps under ``ckpt``), both gathered;
    the resumed run's checkpoint is read back on one rank as one card
    would read it."""
    from intro_to_gaussian_splatting_tpu_torch.train.checkpoint import (
        load_checkpoint,
    )
    ckpt = spec["ckpt"]
    straight = _trainer(mesh, spec, checkpoint_dir=ckpt)
    straight.run(spec["steps"])
    resumed = _trainer(mesh, spec, checkpoint_dir=ckpt)
    restored = resumed.resume(ckpt, step=spec["resume_at"])
    resumed.run(spec["steps"] - restored)
    whole, opt = resumed._gathered_state()
    one_card, one_card_opt, one_card_step = load_checkpoint(
        ckpt, whole, opt, step=spec["steps"])
    return dict(
        restored=restored, steps=[straight.step, resumed.step],
        straight=_model_arrays(straight.gathered_model()),
        resumed=_model_arrays(whole),
        adam_straight={n: _np(g.mu) for n, g in
                       straight._gathered_state()[1].items()},
        adam_resumed={n: _np(g.mu) for n, g in opt.items()},
        checkpoint=_model_arrays(one_card), checkpoint_step=one_card_step)


CASES = dict(render=case_render, loss_grads=case_loss_grads,
             far_tail=case_far_tail, trainer=case_trainer,
             resume=case_resume)


def main(argv) -> int:
    rank, world, port = (int(a) for a in argv[:3])
    case_path, out_dir = Path(argv[3]), Path(argv[4])
    import datetime

    import torch
    import torch.distributed as dist

    from intro_to_gaussian_splatting_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh(device="cpu")
        with open(case_path, "rb") as f:
            cases = pickle.load(f)
        results = {}
        for name, spec in cases.items():
            results[name] = CASES[spec["kind"]](mesh, spec, out_dir)
        with open(out_dir / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

