"""ctypes bindings for the port's host C++: the CPU compositing oracle
(``csrc/oracle.cpp``) and the COLMAP binary reader
(``csrc/colmap_reader.cpp``).

The JAX package's ``utils/native.py`` with its public names and signatures;
arrays in and out are numpy. Each library is built at first use from the
port's own sources into the port's build directory
(``ops/cuda_build.HostSource``: ``g++ -O3 -march=native -fPIC -shared``).

``*_available()`` is false only when there is no C++ compiler on ``PATH``;
a compiler that fails raises with its output, and a corrupt file raises
``ValueError``. The COLMAP readers in ``io/colmap.py`` catch a failed
build of the reader: they warn once and fall back to their Python parser,
as the JAX package does. The oracle, a test reference, has no fallback.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np

from intro_to_gaussian_splatting_tpu_torch.ops import cuda_build
from intro_to_gaussian_splatting_tpu_torch.ops.projection import NUM_REC_ROWS

ORACLE_SOURCE = cuda_build.HostSource("oracle")
COLMAP_SOURCE = cuda_build.HostSource("colmap_reader")

_f32p = ctypes.POINTER(ctypes.c_float)
_f64p = ctypes.POINTER(ctypes.c_double)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_charp = ctypes.POINTER(ctypes.c_char)


class _OracleConfig(ctypes.Structure):
    _fields_ = [
        ("tile_size", ctypes.c_int),
        ("t_threshold", ctypes.c_float),
        ("alpha_clamp", ctypes.c_float),
        ("alpha_min", ctypes.c_float),
        ("pixel_bbox_test", ctypes.c_int),
        ("inclusive_tile_overlap", ctypes.c_int),
        ("skip_last_tile", ctypes.c_int),
    ]


# source name -> {symbol: (restype, argtypes)}
_FUNCTIONS = {
    "oracle": {"oracle_render": (None, [
        _f32p, _u8p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(_OracleConfig), _f32p])},
    "colmap_reader": {
        "colmap_read_points3d": (ctypes.c_int64, [
            _u8p, ctypes.c_int64, ctypes.c_int, _i64p, _f64p, _u8p, _f64p,
            _i64p, _i64p, _i64p, _i64p]),
        "colmap_read_images": (ctypes.c_int64, [
            _u8p, ctypes.c_int64, ctypes.c_int, _i32p, _f64p, _f64p, _i32p,
            _i64p, _charp, _i64p, _f64p, _i64p, _i64p, _i64p]),
    },
}

# source name -> loaded library
_LIBS: Dict[str, ctypes.CDLL] = {}


def _lib(source: cuda_build.HostSource) -> ctypes.CDLL:
    """The library of ``source``, built and loaded at first use."""
    if source.name not in _LIBS:
        path = cuda_build.build([source])[source.name]
        lib = ctypes.CDLL(str(path))
        for symbol, (restype, argtypes) in _FUNCTIONS[source.name].items():
            fn = getattr(lib, symbol)
            fn.restype = restype
            fn.argtypes = argtypes
        _LIBS[source.name] = lib
    return _LIBS[source.name]


def _available(source: cuda_build.HostSource) -> bool:
    if cuda_build.cxx_path() is None:
        return False
    _lib(source)
    return True


def oracle_available() -> bool:
    """True when the oracle builds here: false only without a C++
    compiler; a failing build raises."""
    return _available(ORACLE_SOURCE)


def colmap_available() -> bool:
    """True when the COLMAP reader builds here: false only without a C++
    compiler; a failing build raises."""
    return _available(COLMAP_SOURCE)


def _ptr(a: np.ndarray, ptype):
    return a.ctypes.data_as(ptype)


def oracle_render(records: np.ndarray, valid: np.ndarray,
                  width: int, height: int, config) -> np.ndarray:
    """Golden-oracle render, (height, width, 3) f32. ``records``: the
    (16, N) depth-sorted record matrix (``ops.compositing.sorted_records``);
    ``valid``: (N,) in the same order; ``config``: a RasterizerConfig."""
    records = np.ascontiguousarray(records, dtype=np.float32)
    valid = np.ascontiguousarray(valid, dtype=np.uint8)
    if records.ndim != 2 or records.shape[0] != NUM_REC_ROWS:
        raise ValueError(f"records must be ({NUM_REC_ROWS}, N), not "
                         f"{records.shape}")
    n = records.shape[1]
    if valid.shape != (n,):
        raise ValueError(f"valid must be ({n},), not {valid.shape}")
    image = np.zeros((height, width, 3), dtype=np.float32)
    cfg = _OracleConfig(
        tile_size=config.tile_size,
        t_threshold=config.t_threshold,
        alpha_clamp=config.alpha_clamp,
        alpha_min=config.alpha_min,
        pixel_bbox_test=int(config.compat.pixel_bbox_test),
        inclusive_tile_overlap=int(config.compat.inclusive_tile_overlap),
        skip_last_tile=int(config.compat.skip_last_tile),
    )
    _lib(ORACLE_SOURCE).oracle_render(
        _ptr(records, _f32p), _ptr(valid, _u8p), n, width, height,
        ctypes.byref(cfg), _ptr(image, _f32p))
    return image


def read_points3d_native(path: str) -> dict:
    """points3D.bin as the flat arrays of ``io.colmap.ColmapPoints``'
    fields."""
    fn = _lib(COLMAP_SOURCE).colmap_read_points3d
    buf = np.fromfile(path, dtype=np.uint8)
    total = ctypes.c_int64(0)
    n = fn(_ptr(buf, _u8p), buf.size, 0, None, None, None, None, None,
           None, None, ctypes.byref(total))
    if n < 0:
        raise ValueError(f"corrupt points3D file {path}")
    tt = total.value
    ids = np.empty(n, np.int64)
    xyz = np.empty((n, 3), np.float64)
    rgb = np.empty((n, 3), np.uint8)
    error = np.empty(n, np.float64)
    tl = np.empty(n, np.int64)
    tim = np.empty(tt, np.int64)
    tp2 = np.empty(tt, np.int64)
    n2 = fn(_ptr(buf, _u8p), buf.size, 1, _ptr(ids, _i64p),
            _ptr(xyz, _f64p), _ptr(rgb, _u8p), _ptr(error, _f64p),
            _ptr(tl, _i64p), _ptr(tim, _i64p), _ptr(tp2, _i64p),
            ctypes.byref(total))
    if n2 != n or total.value != tt:
        raise ValueError(f"corrupt points3D file {path}")
    return dict(ids=ids, xyz=xyz, rgb=rgb, error=error, track_lengths=tl,
                track_image_ids=tim, track_point2D_idxs=tp2)


def read_images_native(path: str) -> dict:
    """images.bin as flat arrays: ids, qvec, tvec, camera_ids,
    name_lengths, names (the names' bytes, concatenated), pt_counts, xys,
    point3d_ids."""
    fn = _lib(COLMAP_SOURCE).colmap_read_images
    buf = np.fromfile(path, dtype=np.uint8)
    tp = ctypes.c_int64(0)
    tn = ctypes.c_int64(0)
    n = fn(_ptr(buf, _u8p), buf.size, 0, None, None, None, None, None,
           None, None, None, None, ctypes.byref(tp), ctypes.byref(tn))
    if n < 0:
        raise ValueError(f"corrupt images file {path}")
    npts, nbytes = tp.value, tn.value
    ids = np.empty(n, np.int32)
    qvec = np.empty((n, 4), np.float64)
    tvec = np.empty((n, 3), np.float64)
    cam_ids = np.empty(n, np.int32)
    name_lens = np.empty(n, np.int64)
    names = np.empty(nbytes, np.uint8)
    pt_counts = np.empty(n, np.int64)
    xys = np.empty((npts, 2), np.float64)
    p3d = np.empty(npts, np.int64)
    n2 = fn(_ptr(buf, _u8p), buf.size, 1, _ptr(ids, _i32p),
            _ptr(qvec, _f64p), _ptr(tvec, _f64p), _ptr(cam_ids, _i32p),
            _ptr(name_lens, _i64p), _ptr(names, _charp),
            _ptr(pt_counts, _i64p), _ptr(xys, _f64p), _ptr(p3d, _i64p),
            ctypes.byref(tp), ctypes.byref(tn))
    if n2 != n or (tp.value, tn.value) != (npts, nbytes):
        raise ValueError(f"corrupt images file {path}")
    return dict(ids=ids, qvec=qvec, tvec=tvec, camera_ids=cam_ids,
                name_lengths=name_lens, names=names.tobytes(),
                pt_counts=pt_counts, xys=xys, point3d_ids=p3d)
