"""The port's CLI (``gstpu-torch``) end to end on the CPU.

The JAX package's CLI tests' flows (tests/test_cli.py) run on the port
with ``--cpu``, against a synthetic COLMAP scene with ground-truth images
written by the port's ``make_colmap_scene``: info, render, points with the
keypoint comparison; train (the loss and PSNR improve, the
checkpoint, PLY, render and metrics appear, the end-of-run holdout
evaluation prints) -> eval on the PLY -> resume to a larger budget (the
step count continues) -> a resume with nothing left -> eval with saved
renders; ``train --multihost`` over a world of one rank; fetch with an injected
transport (extract, unknown dataset, the offline error). No network is
touched.
"""

import io
import json
import os
import re
import zipfile

import pytest

from intro_to_gaussian_splatting_tpu_torch import cli
from intro_to_gaussian_splatting_tpu_torch.io.fetch import fetch_dataset
from intro_to_gaussian_splatting_tpu_torch.io.synthetic import (
    make_colmap_scene,
)
from intro_to_gaussian_splatting_tpu_torch.train.checkpoint import (
    list_checkpoint_steps,
)

STEP = re.compile(r"step (\d+): loss ([\d.]+) psnr ([-\d.]+)")
ROW = re.compile(r"(\S+)\s+psnr\s+([-\d.]+)\s+ssim\s+([-\d.]+)")


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("scene"))
    make_colmap_scene(d, num_points=300, num_cameras=3, width=64, height=48,
                      seed=5, write_images=True, device="cpu")
    return d


def _run(capsys, *argv):
    assert cli.main(["--cpu", *argv]) == 0
    out = capsys.readouterr().out
    assert argv[0] == "info" or "device=cpu" in out, out
    return out


def test_info_render_points_bench(scene_dir, tmp_path, capsys):
    out = _run(capsys, "info", scene_dir)
    assert "cameras: 1" in out and "points3D: 300" in out
    render = str(tmp_path / "r.ppm")
    _run(capsys, "render", scene_dir, "-o", render)
    with open(render, "rb") as f:
        assert f.readline() == b"P6\n" and f.readline() == b"64 48\n"
    out = _run(capsys, "points", scene_dir, "-o", str(tmp_path / "p.ppm"),
               "--compare-keypoints")
    assert os.path.exists(tmp_path / "p.ppm")
    err = re.search(r"keypoints matched\): mean ([\d.]+)px", out)
    assert err and float(err.group(1)) < 1e-3, out


def test_train_eval_resume_save_renders(scene_dir, tmp_path, capsys):
    out_dir = str(tmp_path / "out")
    out = _run(capsys, "train", scene_dir, "--iterations", "12", "--out-dir",
               out_dir, "--holdout", "3", "--checkpoint-every", "6",
               "--eval-at-end")
    steps = STEP.findall(out)
    assert len(steps) >= 2, out
    assert float(steps[-1][1]) < float(steps[0][1]), out
    assert float(steps[-1][2]) > float(steps[0][2]), out
    for name in ("point_cloud.ply", "render.ppm", "metrics.jsonl"):
        assert os.path.exists(os.path.join(out_dir, name)), name
    ckpt = os.path.join(out_dir, "ckpt")
    assert list_checkpoint_steps(ckpt) == [6, 12]
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f] == [
            2, 4, 6, 8, 10, 12]
    ev = re.findall(r"eval\[holdout\]\s+(\S+)\s+psnr\s+([-\d.]+)", out)
    assert [e[0] for e in ev] == ["im_0001.png", "mean"], out
    assert float(ev[-1][1]) > 10.0

    ply = os.path.join(out_dir, "point_cloud.ply")
    out = _run(capsys, "eval", scene_dir, "--ply", ply, "--holdout", "3")
    rows = ROW.findall(out)
    assert [r[0] for r in rows] == ["im_0001.png", "mean"], out
    assert float(rows[-1][1]) > 10.0 and -1.0 <= float(rows[-1][2]) <= 1.0

    out = _run(capsys, "train", scene_dir, "--iterations", "18", "--out-dir",
               out_dir, "--resume")
    assert "resumed from step 12 (6 iterations remaining)" in out, out
    steps = STEP.findall(out)
    assert int(steps[0][0]) > 12 and int(steps[-1][0]) == 18, out
    assert list_checkpoint_steps(ckpt) == [6, 12, 18]
    out = _run(capsys, "train", scene_dir, "--iterations", "18", "--out-dir",
               out_dir, "--resume", ckpt)
    assert "resumed from step 18 (0 iterations remaining)" in out, out
    assert not STEP.findall(out)

    renders = str(tmp_path / "renders")
    out = _run(capsys, "eval", scene_dir, "--ply", ply, "--save-renders",
               renders)
    assert sorted(os.listdir(renders)) == ["im_0001.ppm", "im_0002.ppm",
                                           "im_0003.ppm"]


def test_multihost_raises_until_its_slice(scene_dir, tmp_path, capsys):
    """``train --multihost`` (which raised until the parallel/ slice) over
    a world of one gloo rank: it trains, rank 0 writes the checkpoint, the
    PLY, the render and the metrics, and the world is closed after."""
    import torch.distributed as dist

    from tests.torch_mesh_ranks import _free_port

    out_dir = str(tmp_path / "mh")
    out = _run(capsys, "train", scene_dir, "--multihost", "--coordinator",
               f"127.0.0.1:{_free_port()}", "--num-processes", "1",
               "--process-id", "0", "--iterations", "6", "--out-dir",
               out_dir)
    assert "multihost: rank 0 of 1" in out, out
    losses = [float(v[1]) for v in STEP.findall(out)]
    assert len(losses) >= 2 and losses[-1] < losses[0], out
    for name in ("point_cloud.ply", "render.ppm", "metrics.jsonl"):
        assert os.path.exists(os.path.join(out_dir, name)), name
    assert list_checkpoint_steps(os.path.join(out_dir, "ckpt")) == [6]
    assert not dist.is_initialized()


def _fake_urlopen_for(payload: bytes):
    class _Resp:
        status = 200
        headers = {"Content-Length": str(len(payload))}

        def __init__(self):
            self._buf = io.BytesIO(payload)

        def read(self, n):
            return self._buf.read(n)

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    return lambda req, timeout=None: _Resp()


def test_fetch_extracts_unknown_dataset_and_offline(tmp_path):
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        z.writestr("treehill/sparse/0/cameras.txt", "# empty\n")
    out = str(tmp_path / "data")
    assert fetch_dataset("360_extra", out,
                         _urlopen=_fake_urlopen_for(buf.getvalue())) == out
    assert os.path.exists(os.path.join(out, "treehill", "sparse", "0",
                                       "cameras.txt"))
    assert not os.path.exists(os.path.join(out, "360_extra_scenes.zip"))
    with pytest.raises(ValueError):
        fetch_dataset("nope", str(tmp_path))

    def dead(req, timeout=None):
        raise OSError("Network is unreachable")

    with pytest.raises(RuntimeError, match="make_colmap_scene"):
        fetch_dataset("360_extra", str(tmp_path / "off"), _urlopen=dead)
