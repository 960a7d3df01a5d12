"""Port vs JAX package: the fused SSIM (ops/ssim.py, kernels B4a-c) on the
CPU.

The port's ``fused_ssim``, ``fused_ssim_sum`` and
``fused_ssim(precompute_grad=True)`` run their plain versions here (the
summed ``ssim_chw`` map under autograd); they are held against the JAX
package's Pallas kernels in interpret mode at the tolerances of its own
tests/test_ssim_pallas.py: value rtol 1e-5, gradients rtol 1e-4 (atol
1e-6 of the largest), for both ``grad_target`` settings, and the one-pass
value and gradient against the split path at rtol 1e-6 / 1e-5. Every JAX
value and gradient comes from one compiled program. The kernels are held
against these plain versions on the card in test_torch_kernels.py.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from intro_to_gaussian_splatting_tpu.ops.ssim_pallas import (
    fused_ssim as jax_fused_ssim,
    fused_ssim_sum as jax_fused_ssim_sum,
)
from intro_to_gaussian_splatting_tpu_torch.ops import ssim as S
from tests.test_torch_common import jax_fast, np_

H, W = 32, 48


def _images(h=H, w=W, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.0, 1.0, (3, h, w)).astype(np.float32)
    b = np.clip(a + 0.2 * rng.normal(size=a.shape), 0.0, 1.0).astype(
        np.float32)
    return a, b


@functools.lru_cache(maxsize=None)
def _jax_reference():
    """{(op, grad_target): (value, d pred, d target)} of the JAX package,
    op one of "split" (fused_ssim), "sum" (fused_ssim_sum) and
    "precompute" (fused_ssim(precompute_grad=True)). Three of them run, one
    per JAX function; the others follow from them as the JAX package
    defines them: fused_ssim is fused_ssim_sum over the window count
    (ssim_pallas.py:466-468), and without grad_target the one-pass kernel
    computes the same prediction gradient and the target's is zeros
    (:210-250, :437-441)."""
    def run(a, b):
        ref = {("split", False): jax.value_and_grad(
                   lambda x, y: jax_fused_ssim(x, y, interpret=True,
                                               grad_target=False),
                   argnums=(0, 1))(a, b),
               ("sum", True): jax.value_and_grad(
                   lambda x, y: jax_fused_ssim_sum(x, y, 0.01 ** 2,
                                                   0.03 ** 2, True, True),
                   argnums=(0, 1))(a, b),
               ("precompute", True): jax.value_and_grad(
                   lambda x, y: jax_fused_ssim(x, y, interpret=True,
                                               grad_target=True,
                                               precompute_grad=True),
                   argnums=(0, 1))(a, b)}
        return {k: (v,) + g for k, (v, g) in ref.items()}

    ref = jax.tree.map(np.asarray, jax_fast(run, *_images()))
    count = np.float32(3 * (H - 10) * (W - 10))
    ref[("sum", False)] = tuple(x * count for x in ref[("split", False)])
    ref[("split", True)] = tuple(x / count for x in ref[("sum", True)])
    v, dx, dy = ref[("precompute", True)]
    ref[("precompute", False)] = (v, dx, np.zeros_like(dy))
    return ref


def _port(op, grad_target, a, b):
    x = torch.from_numpy(a).requires_grad_(True)
    y = torch.from_numpy(b).requires_grad_(True)
    if op == "sum":
        v = S.fused_ssim_sum(x, y, grad_target=grad_target)
    else:
        v = S.fused_ssim(x, y, grad_target=grad_target,
                         precompute_grad=op == "precompute")
    gx, gy = torch.autograd.grad(v, [x, y])
    return float(v), np_(gx), np_(gy)


@pytest.mark.parametrize("op", ["split", "sum", "precompute"])
@pytest.mark.parametrize("grad_target", [False, True])
def test_fused_ssim_matches_pallas(op, grad_target):
    want = _jax_reference()[(op, grad_target)]
    got = _port(op, grad_target, *_images())
    np.testing.assert_allclose(got[0], float(want[0]), rtol=1e-5, atol=1e-6)
    scale = float(np.abs(want[1]).max())
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-6 * max(scale, 1.0))
    if not grad_target:
        assert not got[2].any() and not want[2].any()


@pytest.mark.parametrize("grad_target", [False, True])
def test_precompute_grad_matches_split_path(grad_target):
    """The one-pass value and gradient (B4c's plain version) against the
    forward and backward passes (B4a, B4b), in the port as in the JAX
    package's own test."""
    a, b = _images(seed=9)
    v1, ga1, gb1 = _port("split", grad_target, a, b)
    v2, ga2, gb2 = _port("precompute", grad_target, a, b)
    np.testing.assert_allclose(v2, v1, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(ga2, ga1, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(gb2, gb1, rtol=1e-5, atol=1e-7)


def test_fused_ssim_surface():
    """Identical images give 1; the mean divides the sum by
    3 (H-10) (W-10); with grad_target=False the target's gradient is
    zeros; shapes are checked."""
    a, b = (torch.from_numpy(x) for x in _images(40, 40, seed=3))
    assert float(S.fused_ssim(a, a)) == pytest.approx(1.0, abs=1e-5)
    assert float(S.fused_ssim(a, b)) == pytest.approx(
        float(S.fused_ssim_sum(a, b)) / (3 * 30 * 30), rel=1e-6)
    x = a.clone().requires_grad_(True)
    y = b.clone().requires_grad_(True)
    for op in (S.fused_ssim_sum, S.fused_ssim_sum_vg):
        gx, gy = torch.autograd.grad(op(x, y, grad_target=False), [x, y])
        assert gx.abs().sum() > 0 and not gy.any()
    with pytest.raises(ValueError, match="SSIM window"):
        S.fused_ssim(a[:, :10], b[:, :10])
    with pytest.raises(ValueError, match="differ in shape"):
        S.fused_ssim(a, b[:, 1:])
