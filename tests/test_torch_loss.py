"""Port vs JAX package: the losses and the fused photometric loss (B3).

``train/loss.py``'s functions against the JAX package's (rtol 1e-5: the
same f32 arithmetic, convolutions summed in another order), and the plain
version of kernel B3, ``fused_photometric_loss_reference`` (the split path:
tile L1 + untile + plain SSIM under autograd + tile MSE), against the JAX
package's fused kernel in interpret mode, at the JAX test's sizes
(tests/test_fused_loss.py) and tolerances: value rel 1e-5, gradient rtol
1e-4 / atol 1e-8, PSNR abs 1e-4, and an exactly-zero gradient outside the
image and in the phantom tiles, with junk there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intro_to_gaussian_splatting_tpu.config import RasterizerConfig
from intro_to_gaussian_splatting_tpu.ops.binning import tile_grid
from intro_to_gaussian_splatting_tpu.ops.fused_loss_pallas import (
    fused_photometric_loss as jax_fused_loss,
    pad_target_chw,
)
from intro_to_gaussian_splatting_tpu.ops.rasterize_pallas import (
    image_to_tiles,
    tile_pixel_mask,
)
from intro_to_gaussian_splatting_tpu.train import loss as jl
from intro_to_gaussian_splatting_tpu_torch.ops import fused_loss as tf
from intro_to_gaussian_splatting_tpu_torch.train import loss as tl
from tests.test_torch_common import jax_fast, np_

CFG = RasterizerConfig(group_tiles=4, groups_per_step=2)


def _images(h, w, seed=0):
    rng = np.random.default_rng(seed)
    target = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    pred = np.clip(target + rng.normal(0, 0.15, (h, w, 3)), 0, 1.2).astype(
        np.float32)
    return rng, pred, target


def test_losses_match():
    rng, pred, target = _images(40, 52)
    jp, jt = jnp.asarray(pred), jnp.asarray(target)
    tp, tt = torch.from_numpy(pred), torch.from_numpy(target)
    for name in ("l1", "psnr", "ssim"):
        got = float(getattr(tl, name)(tp, tt))
        want = float(getattr(jl, name)(jp, jt))
        assert got == pytest.approx(want, rel=1e-5), name
    for wt in (0.0, 0.2):
        assert float(tl.rgb_loss(tp, tt, wt)) == pytest.approx(
            float(jl.rgb_loss(jp, jt, wt)), rel=1e-5)
    np.testing.assert_allclose(
        np_(tl.ssim_chw(tp.permute(2, 0, 1), tt.permute(2, 0, 1),
                        reduce=False)),
        np.asarray(jl.ssim_chw(jp.transpose(2, 0, 1), jt.transpose(2, 0, 1),
                               reduce=False)), rtol=1e-4, atol=1e-6)
    tiles = image_to_tiles(jp, CFG)
    ttiles = image_to_tiles(jt, CFG)
    mask = tile_pixel_mask(40, 52, CFG)
    args = [torch.from_numpy(np.array(x)) for x in (tiles, ttiles, mask)]
    for name in ("tile_l1", "tile_psnr"):
        got = float(getattr(tl, name)(*args))
        want = float(getattr(jl, name)(tiles, ttiles, mask))
        assert got == pytest.approx(want, rel=1e-5), name
    assert float(tl.psnr(tp, tp + 0.1)) == pytest.approx(20.0, abs=1e-3)


def _setup(h, w, seed):
    """Prediction tiles with junk outside the image and in the phantom
    tiles, as the JAX package's own fused-loss test builds them."""
    rng, pred, target = _images(h, w, seed)
    ntx, nty = tile_grid(w, h, CFG.tile_size)
    tiles = image_to_tiles(jnp.asarray(pred), CFG)
    mask3 = jnp.broadcast_to(tile_pixel_mask(h, w, CFG), tiles.shape)
    junk = jnp.asarray(rng.uniform(-3, 3, tiles.shape), jnp.float32)
    tiles = tiles * mask3 + junk * (1.0 - mask3)
    return ntx, nty, np.array(tiles), target, np.asarray(mask3)


@pytest.mark.parametrize("h,w", [(75, 90), (64, 128)])
def test_fused_loss_matches_pallas(h, w):
    wt, ts = 0.2, CFG.tile_size
    ntx, nty, tiles, target, mask3 = _setup(h, w, seed=0)
    tpad = pad_target_chw(jnp.asarray(target), ntx, nty, ts, h, w)
    (want, want_mse), want_g = jax_fast(jax.value_and_grad(
        lambda t: jax_fused_loss(t, tpad, ntx, nty, ts, h, w, wt, True),
        has_aux=True), jnp.asarray(tiles))
    x = torch.from_numpy(tiles).requires_grad_(True)
    chw = torch.from_numpy(target.transpose(2, 0, 1).copy())
    loss, mse = tf.fused_photometric_loss(x, chw, ntx, nty, ts, h, w, wt)
    g, = torch.autograd.grad(loss, x)
    assert float(loss.detach()) == pytest.approx(float(want), rel=1e-5)
    np.testing.assert_allclose(np_(g), np.asarray(want_g), rtol=1e-4,
                               atol=1e-8)
    psnr = float(tl.psnr_from_mse(mse))
    assert psnr == pytest.approx(
        float(-10.0 * jnp.log10(jnp.maximum(want_mse, 1e-12))), abs=1e-4)
    assert not mse.requires_grad
    assert not np_(g)[mask3 == 0].any()


def test_fused_loss_gradient_layout_and_scaling():
    """Five-channel input (the rasterizer's whole output): channels >= 3,
    pixels outside the image and phantom tiles get exactly 0; the backward
    scales the stored gradient by the loss cotangent."""
    h, w, ts = 75, 90, CFG.tile_size
    ntx, nty, tiles, target, mask3 = _setup(h, w, seed=3)
    rng = np.random.default_rng(4)
    full = np.concatenate(
        [tiles, rng.uniform(-3, 3, (tiles.shape[0], 2) + tiles.shape[2:])],
        axis=1).astype(np.float32)
    x = torch.from_numpy(full).requires_grad_(True)
    chw = torch.from_numpy(target.transpose(2, 0, 1).copy())
    loss, _ = tf.fused_photometric_loss(x, chw, ntx, nty, ts, h, w, 0.3)
    g1, = torch.autograd.grad(loss, x)
    g3, = torch.autograd.grad(
        3.0 * tf.fused_photometric_loss(x, chw, ntx, nty, ts, h, w, 0.3)[0],
        x)
    g1 = np_(g1)
    assert g1.shape == full.shape
    assert not g1[:, 3:].any()
    assert not g1[:, :3][mask3 == 0].any()
    assert np.abs(g1[:, :3][mask3 == 1]).max() > 0.0
    np.testing.assert_allclose(np_(g3), 3.0 * g1, rtol=1e-6)
    with pytest.raises(ValueError, match="16-pixel"):
        tf.fused_photometric_loss(x, chw, ntx, nty, 8, h, w, 0.3)
