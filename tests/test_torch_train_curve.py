"""Port vs JAX package: the training-curve script
(``intro_to_gaussian_splatting_tpu_torch.scripts.train_curve``).

``make_problem`` at a small size against the same construction through the
JAX package's functions (the root scripts/train_curve.py:72-115): the true
and initial models' parameters (the KNN scales within f32 rounding),
cameras, capacity and ``TrainConfig``; one camera's target against the
JAX package's ``render_tiled`` (Pallas in interpret mode). Then a short
CPU run with densify brought forward on the problem writes rows with the
JAX script's keys to its own ``--out``, never to the repo's
TRAIN_CURVE.jsonl, and densify moves ``num_active``.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np

from intro_to_gaussian_splatting_tpu.config import (
    RasterizerConfig as JaxRasterizerConfig,
    TrainConfig as JaxTrainConfig,
)
from intro_to_gaussian_splatting_tpu.io.synthetic import (
    random_point_cloud,
    ring_cameras,
)
from intro_to_gaussian_splatting_tpu.models.camera import make_camera
from intro_to_gaussian_splatting_tpu.models.gaussians import init_from_points
from intro_to_gaussian_splatting_tpu.ops.rasterize_pallas import (
    render_tiled as jax_render_tiled,
)
from intro_to_gaussian_splatting_tpu_torch.models.gaussians import PARAM_NAMES
from intro_to_gaussian_splatting_tpu_torch.scripts import train_curve
from tests.test_torch_common import jax_fast, np_

REPO = Path(__file__).resolve().parent.parent
SMALL = ("--cpu --mpix 0.003 --true-n 400 --init-n 100 --cameras 2 "
         "--steps 24").split()
TOL = dict(rtol=1e-4, atol=1e-5)


def _jax_problem(args):
    """The root script's construction, through the JAX package."""
    width = int(round((args.mpix * 1e6 * 3 / 2) ** 0.5 / 16) * 16)
    height = int(round(width * 2 / 3 / 16) * 16)
    xyz_t, rgb_t = random_point_cloud(args.true_n, seed=3, extent=8.0)
    true_model = init_from_points(xyz_t, rgb_t, scale_init=0.06, opacity=0.9,
                                  sh_degree=0, color_space="sh")
    cams = [make_camera(fx=0.85 * width, fy=0.85 * width, width=width,
                        height=height, qvec=qvec, tvec=tvec)
            for qvec, tvec in ring_cameras(args.cameras, width, height,
                                           radius=12.0, z=2.5, seed=1)]
    tcfg = JaxTrainConfig(
        iterations=args.steps, ssim_weight=0.2,
        densify_start=100, densify_stop=args.steps - 100,
        densify_interval=100, opacity_reset_interval=0,
        capacity_multiplier=6.0, sh_degree=0,
        camera_batch=args.camera_batch)
    model = init_from_points(
        xyz_t[:args.init_n], rgb_t[:args.init_n], sh_degree=0,
        color_space="sh",
        capacity=int(args.init_n * tcfg.capacity_multiplier),
        opacity=0.1, scale_init=None)
    return width, height, true_model, cams, tcfg, model


def test_make_problem_matches_jax_construction():
    args = train_curve.parse_args(SMALL)
    problem = train_curve.make_problem(args, "cpu")
    width, height, true_model, cams, tcfg, model = _jax_problem(args)
    assert (problem.width, problem.height) == (width, height) == (64, 48)
    assert problem.rcfg.pairs_per_gaussian == 8
    assert dataclasses.asdict(problem.tcfg) == dataclasses.asdict(tcfg)
    assert problem.model.capacity == model.capacity == 600
    np.testing.assert_array_equal(np_(problem.model.active),
                                  np.asarray(model.active))
    for got, want in ((problem.true_model, true_model),
                      (problem.model, model)):
        assert got.color_space == want.color_space == "sh"
        for name in PARAM_NAMES:
            # the KNN scales: the same f32 formula, summed in another order
            tol = TOL if name == "log_scales" else dict(rtol=0, atol=0)
            np.testing.assert_allclose(np_(getattr(got, name)),
                                       np.asarray(getattr(want, name)),
                                       **tol, err_msg=name)
    assert len(problem.cameras) == len(cams) == 2
    for got, want in zip(problem.cameras, cams):
        for name in ("world2view", "full_proj", "cam_center"):
            np.testing.assert_array_equal(np_(getattr(got, name)),
                                          np.asarray(getattr(want, name)))
    want = np.asarray(jax_fast(jax_render_tiled, true_model, cams[1],
                               config=JaxRasterizerConfig(
                                   pairs_per_gaussian=8)))
    assert not problem.targets_overflowed
    np.testing.assert_allclose(np_(problem.targets[1]), want, **TOL)


def test_short_run_writes_jax_keys_to_its_own_out(tmp_path):
    record = REPO / "TRAIN_CURVE.jsonl"
    record_before = record.read_bytes()
    jax_row, *_, jax_summary = (json.loads(line)
                                for line in record_before.splitlines())
    assert train_curve.parse_args([]).out == "gstpu_out/train_curve.jsonl"

    out = tmp_path / "curve.jsonl"
    out.write_text("a stale line\n")
    args = train_curve.parse_args(SMALL + ["--out", str(out)])
    problem = train_curve.make_problem(args, "cpu")
    problem.tcfg = dataclasses.replace(problem.tcfg, densify_start=8,
                                       densify_interval=8, densify_stop=16)
    problem.log_every = 4
    summary = train_curve.run_problem(problem)

    assert record.read_bytes() == record_before
    *rows, written = (json.loads(line) for line in
                      out.read_text().splitlines())
    assert written == summary
    assert [r["step"] for r in rows] == [4, 8, 12, 16, 20, 24]
    assert all(r.keys() == jax_row.keys() for r in rows)
    assert set(jax_summary) - {"backend"} <= set(summary)
    assert summary["device"] == "cpu" and summary["steps"] == 24
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["psnr"])
               for r in rows)
    assert summary["final_psnr"] > summary["first_psnr"] + 1.0
    # densify at step 8 adds a gaussian; a row holds its step's count
    # before that step's densify
    assert [p["step"] for p in summary["densify_passes"]] == [8, 16]
    first = summary["densify_passes"][0]
    assert first["active_after"] > first["active_before"] == 100
    active = {r["step"]: r["num_active"] for r in rows}
    assert active[8] == 100 and active[12] == first["active_after"]
    assert summary["final_active"] == rows[-1]["num_active"]
