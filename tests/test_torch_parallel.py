"""Port vs JAX package: training over a device mesh (parallel/) on the CPU.

The port runs one rank per device, so its meshes are worlds of OS
processes, one rank each, over gloo (tests/torch_mesh_ranks.py): a 2x2
mesh (4 ranks: both axes, and the SSIM halo's wrap from the last tile
column across the gauss axis) and a 1x1 mesh. Each world is started once
for this module and runs every case; the JAX references run in this
process meanwhile, on one device, with their Pallas kernels in interpret
mode. The cases are tests/test_sharding.py's:

  * the sharded render, ring and all-gather, an odd height, against JAX
    ``render_tiled`` (rtol 1e-4, atol 1e-5);
  * the loss and parameter gradients for (ring, ssim_weight) in
    {F, T} x {0, 0.2} against the JAX single-device objective (loss rtol
    1e-5; gradients rtol 2e-3, atol 1e-6); probe gradients finite, the
    ring's equal to the all-gather's; ``overflowed`` false;
  * the ring's global far-tail admission on 4 strips: each keeps exactly
    its nearest gaussians, as a single-device render of only those;
  * the mesh ``Trainer`` densifies, prunes and improves, and every
    replica's model is bit-equal;
  * a mesh checkpoint / resume bit-equal to a straight run, its file read
    back as one card reads it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intro_to_gaussian_splatting_tpu.config import RasterizerConfig
from intro_to_gaussian_splatting_tpu.models.camera import make_camera
from intro_to_gaussian_splatting_tpu.models.gaussians import (
    GaussianModel as JaxModel,
)
from intro_to_gaussian_splatting_tpu.ops.rasterize_pallas import (
    render_tiled as jax_render_tiled,
)
from intro_to_gaussian_splatting_tpu.parallel.mesh import (
    make_mesh as jax_make_mesh,
)
from intro_to_gaussian_splatting_tpu.parallel.sharded import (
    strip_layout as jax_strip_layout,
)
from intro_to_gaussian_splatting_tpu.train.loss import ssim as jax_ssim
from intro_to_gaussian_splatting_tpu_torch.models.gaussians import PARAM_NAMES
from intro_to_gaussian_splatting_tpu_torch.ops.rasterize import (
    render_tiled as port_render_tiled,
)
from intro_to_gaussian_splatting_tpu_torch.parallel.mesh import mesh_dims
from intro_to_gaussian_splatting_tpu_torch.parallel.sharded import (
    pad_rows,
    strip_layout,
)
from tests.scenes import small_scene
from tests.test_torch_common import (
    jax_fast,
    port_camera,
    port_config,
    port_model,
)
from tests.torch_mesh_ranks import start_world, wait_world

# one tile group per grid step keeps the JAX kernels' interpret programs
# small (test_torch_train.py)
RCFG = RasterizerConfig(chunk_size=128, pairs_per_gaussian=32, group_tiles=2,
                        groups_per_step=1)
MESHES = {"2x2": 4, "1x1": 1}
RENDERS = {  # name: (small_scene arguments, ring)
    "default": (dict(n=64, width=48, height=32, seed=13), True),
    "odd_height": (dict(n=64, width=32, height=24, seed=17), True),
    "allgather": (dict(n=96, width=48, height=48, seed=31), False),
    "ring": (dict(n=96, width=48, height=48, seed=31), True),
}
# 48 rows over 4 strips of 16: windows starting in strip 1, the last tile
# column, read rows of strip 2 through the gauss axis
GRAD_SCENE = dict(n=32, width=32, height=48, seed=29)
GRAD_CASES = [(ring, w) for w in (0.0, 0.2) for ring in (False, True)]


def _spec_model(model):
    m = jax.tree.map(np.asarray, model)
    return dict(params=m.params(), active=m.active,
                color_space=m.color_space)


def _spec_camera(cam):
    return dataclasses.asdict(jax.tree.map(np.asarray, cam))


RCFG_SPEC = dataclasses.asdict(port_config(RCFG))


def _port_render(model, cam):
    with torch.no_grad():
        return port_render_tiled(port_model(model), port_camera(cam),
                                 port_config(RCFG)).numpy()


def _far_tail_scene():
    """6 one-pair gaussians per 16-row strip of a 32x64 image, at
    well-separated depths interleaved across strips (JAX
    test_sharding.py:209, on 4 strips)."""
    W, H, ts, n_strips, per_strip = 32, 64, 16, 4, 6
    n = n_strips * per_strip
    fx = 40.0
    cam = make_camera(fx=fx, fy=fx, width=W, height=H,
                      qvec=np.array([1.0, 0, 0, 0]), tvec=np.zeros(3))
    tan_x, tan_y = W / (2 * fx), H / (2 * fx)
    rng = np.random.default_rng(7)
    depths = 1.0 + 0.11 * rng.permutation(n)
    px = np.tile([8.0, 24.0, 8.4, 24.4, 8.8, 23.6], n_strips)[:n]
    py = (np.repeat(np.arange(n_strips) * ts + 8.0, per_strip)
          + rng.uniform(-1, 1, n))
    ndc_x = 2 * px / (W - 1) - 1
    ndc_y = 2 * py / (H - 1) - 1
    means = np.stack([ndc_x * depths * tan_x, ndc_y * depths * tan_y,
                      depths], axis=1)
    model = JaxModel(
        means=jnp.asarray(means, jnp.float32),
        log_scales=jnp.log(jnp.asarray(depths, jnp.float32) / fx)[:, None]
        * jnp.ones((1, 3)),
        quats=jnp.tile(jnp.asarray([1.0, 0, 0, 0], jnp.float32), (n, 1)),
        opacity_logits=jnp.full((n,), 4.0, jnp.float32),
        sh=jnp.asarray(rng.uniform(0.2, 1.0, (n, 1, 3)), jnp.float32),
        active=jnp.ones((n,), bool), color_space="rgb")
    budget = 4
    keep = np.zeros((n,), bool)
    strip_of = (py // ts).astype(int)
    for s in range(n_strips):
        idx = np.flatnonzero(strip_of == s)
        keep[idx[np.argsort(depths[idx])][:budget]] = True
    return model, cam, budget, keep


def _noisy(model, scale, seed, extra=None):
    rng = np.random.default_rng(seed)
    changes = dict(sh=model.sh + jnp.asarray(
        scale * rng.normal(size=model.sh.shape), jnp.float32))
    changes.update(extra or {})
    return model.replace(**changes)


def _trainer_scene():
    """JAX test_sharding.py:162's: a degraded copy of the true scene in a
    64-slot pool, densified once at step 8 of 24."""
    _, cam, true_model = small_scene(n=48, width=32, height=32, seed=41)
    target = _port_render(true_model, cam)
    noisy = _noisy(true_model, 0.6, 5, dict(
        opacity_logits=true_model.opacity_logits - 1.5))
    cap = 64

    def pad(x, fill=0.0):
        return jnp.concatenate(
            [x, jnp.full((cap - x.shape[0],) + x.shape[1:], fill, x.dtype)])

    model = noisy.replace(
        means=pad(noisy.means), log_scales=pad(noisy.log_scales, -10.0),
        quats=pad(noisy.quats), opacity_logits=pad(noisy.opacity_logits,
                                                   -10.0),
        sh=pad(noisy.sh), active=jnp.arange(cap) < noisy.capacity)
    tcfg = dict(ssim_weight=0.0, densify_start=8, densify_stop=9,
                densify_interval=8, densify_grad_threshold=1e-7,
                opacity_reset_interval=0)
    return dict(kind="trainer", model=_spec_model(model),
                camera=_spec_camera(cam), target=target, rcfg=RCFG_SPEC,
                tcfg=tcfg, steps=24)


def _resume_case(ckpt):
    _, cam, true_model = small_scene(n=64, width=32, height=32, seed=47)
    target = _port_render(true_model, cam)
    return dict(kind="resume", model=_spec_model(_noisy(true_model, 0.4, 3)),
                camera=_spec_camera(cam), target=target, rcfg=RCFG_SPEC,
                tcfg=dict(ssim_weight=0.0, checkpoint_every=4,
                          densify_start=10 ** 9, opacity_reset_interval=0),
                steps=12, resume_at=8, ckpt=str(ckpt))


def _grad_inputs():
    _, cam, model = small_scene(**GRAD_SCENE)
    return cam, model, _port_render(model, cam) * 0.5


def _jax_loss_and_grads(model, cam, target, ssim_weight):
    """The single-device objective, as train_step's (test_sharding.py
    :124-131)."""
    def loss_single(params):
        img = jax_render_tiled(model.replace(**params), cam, RCFG,
                               interpret=True)
        loss = jnp.mean(jnp.abs(img - target))
        if ssim_weight > 0.0:
            loss = ((1.0 - ssim_weight) * loss
                    + ssim_weight * (1.0 - jax_ssim(img, target)))
        return loss

    loss, grads = jax_fast(jax.value_and_grad(loss_single), model.params())
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds' results by mesh and case, rank by rank, and the JAX
    references, computed while the worlds run."""
    cases = {f"render_{name}": dict(
        kind="render", model=_spec_model(small_scene(**kw)[2]),
        camera=_spec_camera(small_scene(**kw)[1]), rcfg=RCFG_SPEC, ring=ring)
        for name, (kw, ring) in RENDERS.items()}
    cam, model, target = _grad_inputs()
    for ring, w in GRAD_CASES:
        cases[f"grads_{ring}_{w}"] = dict(
            kind="loss_grads", model=_spec_model(model),
            camera=_spec_camera(cam), target=target, rcfg=RCFG_SPEC,
            ssim_weight=w, ring=ring)
    cases["trainer"] = _trainer_scene()
    tail_model, tail_cam, budget, keep = _far_tail_scene()
    handles = {}
    for mesh, world in MESHES.items():
        tmp = tmp_path_factory.mktemp(f"world_{mesh}")
        mine = dict(cases, resume=_resume_case(tmp / "ckpt"))
        if world == 4:
            mine["far_tail"] = dict(
                kind="far_tail", model=_spec_model(tail_model),
                camera=_spec_camera(tail_cam), rcfg=RCFG_SPEC,
                max_pairs_local=budget)
        handles[mesh] = start_world(world, mine, tmp)

    ref = {}
    try:
        for name, (kw, _) in RENDERS.items():
            if name != "allgather":          # the same scene as "ring"
                _, c, m = small_scene(**kw)
                ref[name] = np.asarray(jax_fast(
                    jax_render_tiled, m, c, config=RCFG, interpret=True))
        ref["allgather"] = ref["ring"]
        for w in (0.0, 0.2):
            ref[f"grads_{w}"] = _jax_loss_and_grads(model, cam, target, w)
        ref["far_tail_keep"] = np.asarray(jax_fast(
            jax_render_tiled, tail_model.replace(active=jnp.asarray(keep)),
            tail_cam, config=RCFG, interpret=True))
        ref["far_tail_full"] = _port_render(tail_model, tail_cam)
    finally:
        results = {mesh: wait_world(h) for mesh, h in handles.items()}
    return results, ref


def test_mesh_dims_follow_the_jax_rule():
    for n in (1, 2, 4, 8):
        jm = jax_make_mesh(devices=jax.devices()[:n])
        assert mesh_dims(n) == (jm.shape["gauss"], jm.shape["tiles"])
        assert mesh_dims(n, n_gauss_shards=n) == (n, 1)
        assert mesh_dims(n, n_tile_shards=1) == (n, 1)
    with pytest.raises(ValueError, match="3x2 != 4"):
        mesh_dims(4, 3, 2)


def test_strip_layout_matches_jax():
    for height in (24, 32, 48, 64, 3324):
        for n_strips in (1, 2, 4, 8):
            assert strip_layout(height, 16, n_strips) == jax_strip_layout(
                height, 16, n_strips)
    img = torch.arange(24 * 2 * 3, dtype=torch.float32).reshape(24, 2, 3)
    padded = pad_rows(img, 64)
    assert padded.shape == (64, 2, 3)
    assert torch.equal(padded[:24], img) and not padded[24:].any()


@pytest.mark.parametrize("case", list(RENDERS))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_render_matches_jax(worlds, mesh, case):
    results, ref = worlds
    for rank in results[mesh]:
        np.testing.assert_allclose(rank[f"render_{case}"]["image"],
                                   ref[case], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("ring,ssim_weight", GRAD_CASES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_loss_and_grads_match_jax(worlds, mesh, ring, ssim_weight):
    """The sharded objective equals the single-device (1-w)L1 + w(1-SSIM),
    SSIM windows across strip boundaries included, and so do its
    gradients; the loss is the same on every rank."""
    results, ref = worlds
    l_single, g_single = ref[f"grads_{ssim_weight}"]
    ranks = [r[f"grads_{ring}_{ssim_weight}"] for r in results[mesh]]
    for got in ranks:
        assert got["loss"] == ranks[0]["loss"]
        np.testing.assert_allclose(float(got["loss"]), l_single, rtol=1e-5)
        for name in PARAM_NAMES:
            np.testing.assert_allclose(
                got[f"grad_{name}"], g_single[name], rtol=2e-3, atol=1e-6,
                err_msg=f"sharded grad mismatch: {name} (ring={ring})")
        assert np.isfinite(got["grad_probe"]).all()
        assert not bool(got["overflowed"])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_ring_probe_and_accounting_match_allgather(worlds, mesh):
    """Screen-space probe gradients: ring vs all-gather paths agree
    (test_sharding.py:288), and both report their pair accounting."""
    results, _ = worlds
    for rank in results[mesh]:
        for w in (0.0, 0.2):
            ring, gathered = rank[f"grads_True_{w}"], rank[f"grads_False_{w}"]
            np.testing.assert_allclose(ring["grad_probe"],
                                       gathered["grad_probe"], rtol=2e-3,
                                       atol=1e-7)
            for got in (ring, gathered):
                assert got["ring_demand"] >= got["ring_emitted"] > 0
                moved = float(got["ring_bytes_per_device"])
                assert moved > 0 if mesh == "2x2" else moved == 0


def test_ring_far_tail_admission(worlds):
    """A strip's pair budget overflows: the flag rises on every strip, and
    whole gaussians drop far to near by GLOBAL depth, whatever the order
    their shards arrive in (test_sharding.py:209)."""
    results, ref = worlds
    for rank in results["2x2"]:
        got = rank["far_tail"]
        assert got["overflowed"].all(), "the flag must rise on every strip"
        np.testing.assert_allclose(got["image"], ref["far_tail_keep"],
                                   rtol=1e-4, atol=1e-5)
    assert np.abs(ref["far_tail_full"] - got["image"]).max() > 1e-3


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_trainer_densifies_with_equal_replicas(worlds, mesh):
    """The mesh Trainer runs the whole recipe: densification grows the
    active count, optimisation recovers through it, and every rank holds
    the same model bit for bit, its shard equal to its tile replica's
    (test_sharding.py:162)."""
    results, _ = worlds
    ranks = [r["trainer"] for r in results[mesh]]
    hist = ranks[0]["history"]

    def metrics(h):                  # all but each rank's own wall clock
        return [{k: v for k, v in m.items() if k != "sec"} for m in h]

    assert all(metrics(r["history"]) == metrics(hist) for r in ranks)
    assert hist[-1]["num_active"] > 48, f"densification never fired: {hist}"
    post = next(m for m in hist if m["num_active"] > 48)
    assert hist[-1]["loss"] < post["loss"] * 0.95, (post, hist[-1])
    assert hist[-1]["psnr"] > post["psnr"] + 0.2, (post, hist[-1])
    assert all(np.isfinite(m["loss"]) for m in hist), hist
    for r in ranks[1:]:
        for name, value in ranks[0]["gathered"].items():
            np.testing.assert_array_equal(r["gathered"][name], value)
    if mesh == "2x2":
        # ranks (g, 0) and (g, 1) are one shard's tile replicas
        for g in (0, 1):
            a, b = ranks[2 * g], ranks[2 * g + 1]
            for name in a["shard"]:
                np.testing.assert_array_equal(a["shard"][name],
                                              b["shard"][name])
            for name in a["adam_mu"]:
                np.testing.assert_array_equal(a["adam_mu"][name],
                                              b["adam_mu"][name])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_resume_is_bit_equal(worlds, mesh):
    """A mesh Trainer resumed from step 8 reaches step 12 bit-equal to the
    straight run (test_sharding.py:306), and the checkpoint rank 0 wrote
    holds that state in the single-card format."""
    results, _ = worlds
    for rank in results[mesh]:
        got = rank["resume"]
        assert got["restored"] == 8 and got["steps"] == [12, 12]
        assert got["checkpoint_step"] == 12
        for name, value in got["straight"].items():
            np.testing.assert_array_equal(got["resumed"][name], value)
            np.testing.assert_array_equal(got["checkpoint"][name], value)
        for name, value in got["adam_straight"].items():
            np.testing.assert_array_equal(got["adam_resumed"][name], value)
