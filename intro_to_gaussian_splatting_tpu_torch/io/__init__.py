from intro_to_gaussian_splatting_tpu_torch.io.colmap import (
    ColmapCamera,
    ColmapImage,
    ColmapPoints,
    read_cameras,
    read_images,
    read_model,
    read_points3D,
    write_cameras_binary,
    write_images_binary,
    write_points3D_binary,
)
from intro_to_gaussian_splatting_tpu_torch.io.dataset import (
    SceneData,
    load_scene,
    resolve_sparse,
)
from intro_to_gaussian_splatting_tpu_torch.io.ply import read_ply, write_ply

__all__ = [
    "ColmapCamera",
    "ColmapImage",
    "ColmapPoints",
    "read_cameras",
    "read_images",
    "read_model",
    "read_points3D",
    "write_cameras_binary",
    "write_images_binary",
    "write_points3D_binary",
    "SceneData",
    "load_scene",
    "resolve_sparse",
    "read_ply",
    "write_ply",
]
