"""COLMAP sparse-model reader (binary + text) and binary writer, pure NumPy.

The port's own copy of the JAX package's readers and writers. The on-disk
formats are fixed by COLMAP itself
(colmap/src/colmap/scene/reconstruction.cc). The whole file is read once
and fixed-size records are decoded with ``np.frombuffer`` views, with one
thin Python loop over the variable-length image/point records. Where a C++
compiler is available, ``images.bin`` and ``points3D.bin`` go through the
native reader (``utils/native.py``, ``csrc/colmap_reader.cpp``) instead,
as in the JAX package; a corrupt file then raises ``ValueError``. When the
reader fails to build (a broken ``$CXX``, a build directory that cannot be
written), the first read warns once and the process's reads fall back to
the Python parser, as the JAX package's do, without running the compiler
again; ``native.colmap_available()`` itself still raises. The output is
struct-of-arrays.
"""

from __future__ import annotations

import dataclasses
import os
import struct
import warnings
from typing import Dict, Tuple

import numpy as np

from intro_to_gaussian_splatting_tpu_torch.utils import native

# set once the native reader has failed to build in this process: reads then
# use the Python parser and the compiler is not run again
_native_build_failed = False


def _native_reader() -> bool:
    """True when the native COLMAP reader is to be used. A failed build
    warns once per process and falls back to the Python parser; a corrupt
    file still raises from the native reader."""
    global _native_build_failed
    if _native_build_failed:
        return False
    try:
        return native.colmap_available()
    except (RuntimeError, OSError) as e:
        _native_build_failed = True
        first = str(e).partition("\n")[0].rstrip(":")
        warnings.warn(f"the native COLMAP reader did not build ({first}); "
                      "the Python parser reads COLMAP files instead",
                      RuntimeWarning, stacklevel=3)
        return False

# model_id -> (name, num_params); fixed by COLMAP (ref: splat/read_colmap.py:21-33)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_NAMES = {name: (mid, n) for mid, (name, n) in CAMERA_MODELS.items()}


@dataclasses.dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray  # (num_params,) f64

    @property
    def fx(self) -> float:
        return float(self.params[0])

    @property
    def fy(self) -> float:
        if self.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL",
                          "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE"):
            return float(self.params[0])
        return float(self.params[1])

    @property
    def cx(self) -> float:
        i = 1 if self.model.startswith(("SIMPLE", "RADIAL")) else 2
        return float(self.params[i])

    @property
    def cy(self) -> float:
        i = 2 if self.model.startswith(("SIMPLE", "RADIAL")) else 3
        return float(self.params[i])


@dataclasses.dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray        # (4,) wxyz
    tvec: np.ndarray        # (3,)
    camera_id: int
    name: str
    xys: np.ndarray         # (P, 2) 2D keypoints
    point3D_ids: np.ndarray  # (P,) int64, -1 = unmatched


@dataclasses.dataclass
class ColmapPoints:
    """All 3D points as struct-of-arrays."""

    ids: np.ndarray          # (N,) int64
    xyz: np.ndarray          # (N, 3) f64
    rgb: np.ndarray          # (N, 3) u8
    error: np.ndarray        # (N,) f64
    track_lengths: np.ndarray  # (N,) int64
    # flattened track: per observation (image_id, point2D_idx)
    track_image_ids: np.ndarray
    track_point2D_idxs: np.ndarray

    def __len__(self) -> int:
        return len(self.ids)

    def filter_by_track_length(self, min_track: int = 2) -> "ColmapPoints":
        """Keep points observed in >= min_track images (the reference filters
        to track >= 2 before building Gaussians: part_1.ipynb cell 1)."""
        keep = self.track_lengths >= min_track
        offsets = np.concatenate([[0], np.cumsum(self.track_lengths)])
        track_keep = np.zeros(len(self.track_image_ids), dtype=bool)
        for i in np.nonzero(keep)[0]:
            track_keep[offsets[i]:offsets[i + 1]] = True
        return ColmapPoints(
            ids=self.ids[keep],
            xyz=self.xyz[keep],
            rgb=self.rgb[keep],
            error=self.error[keep],
            track_lengths=self.track_lengths[keep],
            track_image_ids=self.track_image_ids[track_keep],
            track_point2D_idxs=self.track_point2D_idxs[track_keep],
        )


# ---------------------------------------------------------------------------
# Binary readers
# ---------------------------------------------------------------------------

def read_cameras_binary(path: str) -> Dict[int, ColmapCamera]:
    """cameras.bin: u64 count, then per camera i32 id, i32 model, u64 w, u64 h,
    f64 params[num_params] (ref record layout: splat/read_colmap.py:125-140)."""
    cameras: Dict[int, ColmapCamera] = {}
    with open(path, "rb") as f:
        buf = f.read()
    (num,) = struct.unpack_from("<Q", buf, 0)
    off = 8
    for _ in range(num):
        cam_id, model_id, width, height = struct.unpack_from("<iiQQ", buf, off)
        off += 24
        name, num_params = CAMERA_MODELS[model_id]
        params = np.frombuffer(buf, dtype="<f8", count=num_params, offset=off).copy()
        off += 8 * num_params
        cameras[cam_id] = ColmapCamera(cam_id, name, int(width), int(height), params)
    assert len(cameras) == num
    return cameras


def read_images_binary(path: str) -> Dict[int, ColmapImage]:
    """images.bin: u64 count, then per image: i32 id, 4xf64 qvec, 3xf64 tvec,
    i32 camera_id, NUL-terminated name, u64 npts, npts x (f64 x, f64 y, i64 id)
    (ref: splat/read_colmap.py:200-238)."""
    if _native_reader():
        return _images_from_native(native.read_images_native(path))
    images: Dict[int, ColmapImage] = {}
    with open(path, "rb") as f:
        buf = f.read()
    (num,) = struct.unpack_from("<Q", buf, 0)
    off = 8
    for _ in range(num):
        vals = struct.unpack_from("<idddddddi", buf, off)
        off += 64
        image_id = vals[0]
        qvec = np.array(vals[1:5])
        tvec = np.array(vals[5:8])
        camera_id = vals[8]
        end = buf.index(b"\x00", off)
        name = buf[off:end].decode("utf-8")
        off = end + 1
        (npts,) = struct.unpack_from("<Q", buf, off)
        off += 8
        rec = np.frombuffer(buf, dtype="<f8", count=3 * npts, offset=off).reshape(npts, 3)
        xys = rec[:, :2].copy()
        point3D_ids = rec[:, 2].view("<i8").copy()
        off += 24 * npts
        images[image_id] = ColmapImage(
            image_id, qvec, tvec, camera_id, name, xys, point3D_ids
        )
    assert len(images) == num
    return images


def _images_from_native(d) -> Dict[int, ColmapImage]:
    images: Dict[int, ColmapImage] = {}
    off_pts = 0
    off_name = 0
    for i in range(len(d["ids"])):
        nl = int(d["name_lengths"][i])
        np_ = int(d["pt_counts"][i])
        images[int(d["ids"][i])] = ColmapImage(
            id=int(d["ids"][i]),
            qvec=d["qvec"][i],
            tvec=d["tvec"][i],
            camera_id=int(d["camera_ids"][i]),
            name=d["names"][off_name:off_name + nl].decode("utf-8"),
            xys=d["xys"][off_pts:off_pts + np_],
            point3D_ids=d["point3d_ids"][off_pts:off_pts + np_],
        )
        off_pts += np_
        off_name += nl
    return images


def read_points3D_binary(path: str) -> ColmapPoints:
    """points3D.bin: u64 count, then per point: u64 id, 3xf64 xyz, 3xu8 rgb,
    f64 error (43 bytes), u64 track_len, track_len x (i32 image_id, i32 p2d)
    (ref: splat/read_colmap.py:284-300)."""
    if _native_reader():
        return ColmapPoints(**native.read_points3d_native(path))
    with open(path, "rb") as f:
        buf = f.read()
    (num,) = struct.unpack_from("<Q", buf, 0)
    off = 8
    ids = np.empty(num, dtype=np.int64)
    xyz = np.empty((num, 3), dtype=np.float64)
    rgb = np.empty((num, 3), dtype=np.uint8)
    error = np.empty(num, dtype=np.float64)
    track_lengths = np.empty(num, dtype=np.int64)
    tracks = []
    for i in range(num):
        pid, x, y, z, r, g, b, err = struct.unpack_from("<QdddBBBd", buf, off)
        off += 43
        (tlen,) = struct.unpack_from("<Q", buf, off)
        off += 8
        t = np.frombuffer(buf, dtype="<i4", count=2 * tlen, offset=off).reshape(tlen, 2)
        off += 8 * tlen
        ids[i] = pid
        xyz[i] = (x, y, z)
        rgb[i] = (r, g, b)
        error[i] = err
        track_lengths[i] = tlen
        tracks.append(t)
    track = (
        np.concatenate(tracks, axis=0)
        if tracks
        else np.zeros((0, 2), dtype=np.int32)
    )
    return ColmapPoints(
        ids=ids, xyz=xyz, rgb=rgb, error=error, track_lengths=track_lengths,
        track_image_ids=track[:, 0].astype(np.int64),
        track_point2D_idxs=track[:, 1].astype(np.int64),
    )


# ---------------------------------------------------------------------------
# Text readers (format: colmap WriteCamerasText etc.)
# ---------------------------------------------------------------------------

def read_cameras_text(path: str) -> Dict[int, ColmapCamera]:
    cameras: Dict[int, ColmapCamera] = {}
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            elems = line.split()
            cam_id = int(elems[0])
            cameras[cam_id] = ColmapCamera(
                cam_id, elems[1], int(elems[2]), int(elems[3]),
                np.array([float(x) for x in elems[4:]]),
            )
    return cameras


def read_images_text(path: str) -> Dict[int, ColmapImage]:
    images: Dict[int, ColmapImage] = {}
    with open(path, "r") as f:
        lines = [ln.strip() for ln in f if ln.strip() and not ln.startswith("#")]
    for hdr, pts in zip(lines[0::2], lines[1::2]):
        elems = hdr.split()
        image_id = int(elems[0])
        qvec = np.array([float(x) for x in elems[1:5]])
        tvec = np.array([float(x) for x in elems[5:8]])
        camera_id = int(elems[8])
        name = elems[9]
        p = pts.split()
        xys = np.array(
            [[float(a), float(b)] for a, b in zip(p[0::3], p[1::3])]
        ).reshape(-1, 2)
        ids = np.array([int(x) for x in p[2::3]], dtype=np.int64)
        images[image_id] = ColmapImage(image_id, qvec, tvec, camera_id, name, xys, ids)
    return images


def read_points3D_text(path: str) -> ColmapPoints:
    rows = []
    tracks = []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            e = line.split()
            rows.append((int(e[0]), float(e[1]), float(e[2]), float(e[3]),
                         int(e[4]), int(e[5]), int(e[6]), float(e[7])))
            t = np.array([int(x) for x in e[8:]], dtype=np.int64).reshape(-1, 2)
            tracks.append(t)
    n = len(rows)
    arr = np.array(rows, dtype=np.float64).reshape(n, 8)
    track_lengths = np.array([len(t) for t in tracks], dtype=np.int64)
    track = (
        np.concatenate(tracks, axis=0) if tracks else np.zeros((0, 2), np.int64)
    )
    return ColmapPoints(
        ids=arr[:, 0].astype(np.int64),
        xyz=arr[:, 1:4].copy(),
        rgb=arr[:, 4:7].astype(np.uint8),
        error=arr[:, 7].copy(),
        track_lengths=track_lengths,
        track_image_ids=track[:, 0],
        track_point2D_idxs=track[:, 1],
    )


# ---------------------------------------------------------------------------
# Dispatchers (binary preferred, like ref splat/utils.py:269-290)
# ---------------------------------------------------------------------------

def _dispatch(path: str, stem: str, bin_fn, txt_fn):
    bpath = os.path.join(path, stem + ".bin")
    tpath = os.path.join(path, stem + ".txt")
    if os.path.exists(bpath):
        return bin_fn(bpath)
    if os.path.exists(tpath):
        return txt_fn(tpath)
    raise FileNotFoundError(f"neither {bpath} nor {tpath} exists")


def read_cameras(model_path: str) -> Dict[int, ColmapCamera]:
    return _dispatch(model_path, "cameras", read_cameras_binary, read_cameras_text)


def read_images(model_path: str) -> Dict[int, ColmapImage]:
    return _dispatch(model_path, "images", read_images_binary, read_images_text)


def read_points3D(model_path: str) -> ColmapPoints:
    return _dispatch(model_path, "points3D", read_points3D_binary, read_points3D_text)


def read_model(model_path: str) -> Tuple[Dict[int, ColmapCamera], Dict[int, ColmapImage], ColmapPoints]:
    """Read a full sparse model directory (e.g. scene/sparse/0)."""
    return read_cameras(model_path), read_images(model_path), read_points3D(model_path)


# ---------------------------------------------------------------------------
# Binary writers (synthetic scenes and round trips; the formats mirror the
# readers above, byte for byte those of the JAX package's writers)
# ---------------------------------------------------------------------------

def write_cameras_binary(cameras: Dict[int, ColmapCamera], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam in cameras.values():
            model_id, num_params = CAMERA_MODEL_NAMES[cam.model]
            if len(cam.params) != num_params:
                raise ValueError(f"camera {cam.id}: {cam.model} takes "
                                 f"{num_params} params, got {cam.params}")
            f.write(struct.pack("<iiQQ", cam.id, model_id, cam.width,
                                cam.height))
            f.write(np.asarray(cam.params, dtype="<f8").tobytes())


def write_images_binary(images: Dict[int, ColmapImage], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<idddddddi", im.id, *im.qvec, *im.tvec,
                                im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            n = len(im.xys)
            f.write(struct.pack("<Q", n))
            rec = np.empty((n, 3), dtype="<f8")
            rec[:, :2] = im.xys
            rec[:, 2] = np.asarray(im.point3D_ids, dtype="<i8").view("<f8")
            f.write(rec.tobytes())


def write_points3D_binary(points: ColmapPoints, path: str) -> None:
    offsets = np.concatenate([[0], np.cumsum(points.track_lengths)])
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for i in range(len(points)):
            f.write(struct.pack(
                "<QdddBBBd",
                int(points.ids[i]), *points.xyz[i],
                *(int(c) for c in points.rgb[i]), float(points.error[i]),
            ))
            lo, hi = offsets[i], offsets[i + 1]
            f.write(struct.pack("<Q", hi - lo))
            t = np.empty((hi - lo, 2), dtype="<i4")
            t[:, 0] = points.track_image_ids[lo:hi]
            t[:, 1] = points.track_point2D_idxs[lo:hi]
            f.write(t.tobytes())
