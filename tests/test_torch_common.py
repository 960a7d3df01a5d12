"""Helpers shared by the PyTorch port's parity tests, and tests of the
port's device rule and its model conversion.

The parity tests build one scene with numpy from a seed (tests/scenes.py),
run it through the JAX package and, converted through numpy, through the
port on the CPU, and compare. The CUDA kernels' tests are in
test_torch_kernels.py, which imports no JAX so that it runs on the card.

The JAX references run once each, on small inputs, with their Pallas
kernels in interpret mode: tracing and XLA's compile take nearly all their
time. ``jax_fast`` compiles them without LLVM's optimizations (the same
arithmetic, about a third less time), and each file computes a reference
once and shares it between the tests that read it.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from intro_to_gaussian_splatting_tpu.config import RasterizerConfig as JaxConfig
from intro_to_gaussian_splatting_tpu_torch import convert
from intro_to_gaussian_splatting_tpu_torch.config import (
    CompatConfig,
    RasterizerConfig,
)
from intro_to_gaussian_splatting_tpu_torch.device import resolve_device
from intro_to_gaussian_splatting_tpu_torch.ops.projection import (
    ProjectedGaussians,
)
from tests.scenes import small_scene


FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def jax_fast(fn, *args, **static):
    """``fn(*args, **static)`` through ``jax.jit`` compiled with
    FAST_COMPILE; ``static`` are the static arguments (already declared if
    ``fn`` is jitted)."""
    if not hasattr(fn, "lower"):
        fn = jax.jit(fn, static_argnames=tuple(static))
    return fn.lower(*args, **static).compile(FAST_COMPILE)(*args)


def port_model(model, device="cpu"):
    """The port's GaussianModel holding a JAX model's weights."""
    m = jax.tree.map(np.asarray, model)
    return convert.model_from_numpy(m.params(), m.active, m.color_space,
                                    device=device)


def port_camera(cam, device="cpu"):
    return convert.camera_from_numpy(
        dataclasses.asdict(jax.tree.map(np.asarray, cam)), device=device)


def port_config(cfg: JaxConfig) -> RasterizerConfig:
    """The port's RasterizerConfig with the same field values."""
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(cfg) if f.name != "compat"}
    return RasterizerConfig(**fields, compat=CompatConfig(
        **dataclasses.asdict(cfg.compat)))


def port_projection(proj, device="cpu") -> ProjectedGaussians:
    """The JAX package's ProjectedGaussians as the port's."""
    return ProjectedGaussians(**{
        f.name: torch.from_numpy(np.array(getattr(proj, f.name))).to(device)
        for f in dataclasses.fields(proj)})


def np_(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def test_entry_points_default_to_the_card(monkeypatch):
    from intro_to_gaussian_splatting_tpu_torch.models import (
        init_from_points, make_camera,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_camera(10.0, 10.0, 16, 16, np.array([1.0, 0, 0, 0]),
                    np.zeros(3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_from_points(np.zeros((4, 3)), np.zeros((4, 3), np.uint8))
    assert resolve_device("cpu") == torch.device("cpu")


def test_model_from_numpy_keeps_weights_bit_for_bit():
    raw, cam, model = small_scene(n=30, seed=2)
    tm = port_model(model)
    assert isinstance(tm, torch.nn.Module)
    assert sorted(n for n, _ in tm.named_parameters()) == sorted(
        convert.PARAM_NAMES)
    assert [n for n, _ in tm.named_buffers()] == ["active"]
    assert tm.color_space == "rgb"
    for name in convert.PARAM_NAMES:
        np.testing.assert_array_equal(np_(getattr(tm, name)),
                                      np.asarray(getattr(model, name)))
    np.testing.assert_array_equal(np_(tm.active), np.asarray(model.active))
    tc = port_camera(cam)
    for name in convert.CAMERA_TENSORS:
        np.testing.assert_array_equal(np_(getattr(tc, name)),
                                      np.asarray(getattr(cam, name)))
    assert (tc.width, tc.height) == (cam.width, cam.height)

