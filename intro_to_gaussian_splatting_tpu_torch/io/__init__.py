from intro_to_gaussian_splatting_tpu_torch.io.colmap import (
    ColmapCamera,
    ColmapImage,
    ColmapPoints,
    read_cameras,
    read_images,
    read_model,
    read_points3D,
)
from intro_to_gaussian_splatting_tpu_torch.io.dataset import resolve_sparse

__all__ = [
    "ColmapCamera",
    "ColmapImage",
    "ColmapPoints",
    "read_cameras",
    "read_images",
    "read_model",
    "read_points3D",
    "resolve_sparse",
]
