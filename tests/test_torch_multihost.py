"""The port's multi-process surface (parallel/multihost.py) on the CPU.

``multihost_smoke`` in four real OS processes, one rank each over gloo
(the JAX package's tests/test_multihost.py runs two processes of two
devices: the same 2x2 mesh): every rank joins, loads only its own strip
rows and takes three sharded train steps, and all print the same falling
losses. Then the helpers that give a rank its share of what every rank
holds whole, on a mesh built without a world (they make no collective
call), the Trainer's refusal of camera batches under a mesh, and a world
of one formed by ``init_multihost``.
"""

import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from intro_to_gaussian_splatting_tpu.parallel.sharded import (
    strip_layout as jax_strip_layout,
)
from intro_to_gaussian_splatting_tpu_torch.models import init_from_points
from intro_to_gaussian_splatting_tpu_torch.parallel.mesh import (
    GAUSS_AXIS,
    Mesh,
    mesh_shape,
)
from intro_to_gaussian_splatting_tpu_torch.parallel.multihost import (
    global_mesh,
    globalize_target,
    init_multihost,
    process_local_rows,
    put_global,
    put_global_tree,
)
from intro_to_gaussian_splatting_tpu_torch.train.densify import DensifyState

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_four_process_sharded_train_step():
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, "-m",
         "intro_to_gaussian_splatting_tpu_torch.parallel.multihost_smoke",
         str(pid), "4", f"127.0.0.1:{port}", "--cpu"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for pid in range(4)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {pid} failed:\n{out}"
    parsed = []
    for pid, out in enumerate(outs):
        m = re.search(rf"SMOKE pid={pid} losses=([\d.,-]+) psnr=([-\d.]+)",
                      out)
        assert m, out
        parsed.append((tuple(float(x) for x in m.group(1).split(",")),
                       float(m.group(2))))
    # all-reduced scalars: every rank prints the same
    assert all(p == parsed[0] for p in parsed), parsed
    losses = parsed[0][0]
    assert losses[-1] < losses[0], parsed
    assert all(v > 0 for v in losses)


def _mesh(g_idx, t_idx, g=2, t=2):
    return Mesh(n_gauss=g, n_tiles=t, g_idx=g_idx, t_idx=t_idx,
                device=torch.device("cpu"), gauss_group=None,
                tile_group=None)


@pytest.mark.parametrize("height", [24, 48, 64])
def test_each_rank_loads_its_own_strip(height):
    """The ranks' rows tile the padded image in strip order, and a rank's
    target is exactly its rows."""
    _, padded_h = jax_strip_layout(height, 16, 4)
    image = np.arange(padded_h * 5 * 3, dtype=np.float32).reshape(
        padded_h, 5, 3)
    covered = []
    for rank in range(4):
        mesh = _mesh(*divmod(rank, 2))
        row0, rows = process_local_rows(height, 16, mesh)
        assert rows * 4 == padded_h
        covered += range(row0, row0 + rows)
        strip = globalize_target(image[row0:row0 + rows], padded_h, mesh)
        assert strip.dtype == torch.float32
        np.testing.assert_array_equal(strip.numpy(),
                                      image[row0:row0 + rows])
    assert covered == list(range(padded_h))
    with pytest.raises(ValueError, match="do not make"):
        globalize_target(image[:3], padded_h, _mesh(0, 0))


def test_put_global_takes_the_gauss_shard():
    model = init_from_points(np.random.default_rng(0).normal(size=(8, 3)),
                             np.full((8, 3), 128, np.uint8), device="cpu")
    state = DensifyState(grad_accum=torch.arange(8.0),
                         count=torch.arange(8, dtype=torch.int32))
    for g_idx in (0, 1):
        mesh = _mesh(g_idx, 1)
        rows = slice(4 * g_idx, 4 * g_idx + 4)
        shard = put_global_tree(model, mesh, GAUSS_AXIS)
        assert shard.capacity == 4
        assert torch.equal(shard.means, model.means.detach()[rows])
        assert torch.equal(shard.active, model.active[rows])
        st = put_global_tree(state, mesh, GAUSS_AXIS)
        assert torch.equal(st.count, state.count[rows])
        assert torch.equal(put_global(state.grad_accum, mesh),
                           state.grad_accum)
    with pytest.raises(ValueError, match="gauss"):
        put_global(state.count, _mesh(0, 0), "tiles")


def test_camera_batch_under_a_mesh_raises():
    """The JAX package trains one camera per step under a mesh whatever
    ``camera_batch`` says (its trainer.py:525); the port refuses."""
    from intro_to_gaussian_splatting_tpu_torch.config import TrainConfig
    from intro_to_gaussian_splatting_tpu_torch.models import make_camera
    from intro_to_gaussian_splatting_tpu_torch.train.trainer import Trainer

    model = init_from_points(np.zeros((4, 3)), np.zeros((4, 3), np.uint8),
                             device="cpu")
    cam = make_camera(10.0, 10.0, 16, 16, np.array([1.0, 0, 0, 0]),
                      np.zeros(3), device="cpu")
    with pytest.raises(ValueError, match="camera_batch"):
        Trainer(model=model, cameras=[cam, cam],
                targets=[np.zeros((16, 16, 3))] * 2, scene_extent=1.0,
                tcfg=TrainConfig(camera_batch=2), mesh=_mesh(0, 0))


def test_a_world_of_one():
    """``init_multihost`` forms a gloo world at a coordinator's address for
    the CPU; the global mesh over it is 1x1 and its groups reduce. Without
    a world there is no mesh."""
    with pytest.raises(RuntimeError, match="init_multihost"):
        global_mesh(device="cpu")
    device = init_multihost(f"127.0.0.1:{_free_port()}", 1, 0, device="cpu")
    try:
        assert device == torch.device("cpu")
        assert dist.get_backend() == "gloo"
        mesh = global_mesh(device="cpu")
        assert (mesh_shape(mesh), mesh.rank) == ((1, 1), 0)
        x = torch.ones(3)
        dist.all_reduce(x, group=mesh.tile_group)
        assert torch.equal(x, torch.ones(3))
    finally:
        dist.destroy_process_group()
