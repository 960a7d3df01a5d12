from intro_to_gaussian_splatting_tpu_torch.models.camera import (
    Camera,
    camera_from_colmap,
    index_camera,
    make_camera,
    stack_cameras,
)
from intro_to_gaussian_splatting_tpu_torch.models.gaussians import (
    GaussianModel,
    init_from_points,
    knn_mean_scale,
)
from intro_to_gaussian_splatting_tpu_torch.models.sh import (
    eval_sh,
    num_sh_coeffs,
    rgb_to_sh,
    sh_to_rgb,
)

__all__ = [
    "Camera",
    "camera_from_colmap",
    "index_camera",
    "make_camera",
    "stack_cameras",
    "GaussianModel",
    "init_from_points",
    "knn_mean_scale",
    "eval_sh",
    "num_sh_coeffs",
    "rgb_to_sh",
    "sh_to_rgb",
]
