"""Minimal PLY point-cloud IO, pure NumPy (no ``plyfile`` dependency).

The port's own copy of the JAX package's ``io/ply.py``; the two write the
same bytes. The vertex layout is binary little endian: x/y/z (f4),
nx/ny/nz (f4), optionally red/green/blue (u1), then any extra float
properties, as the standard 3DGS checkpoint layout has them (``f_dc_*``,
``f_rest_*``, ``opacity``, ``scale_*``, ``rot_*``), so exported scenes open
in public 3DGS viewers. The reader also takes ASCII files.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}
_INV_DTYPES = {"f4": "float", "f8": "double", "u1": "uchar", "i4": "int",
               "u4": "uint"}


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Read the first ``vertex`` element: {property name: (N,) array}."""
    with open(path, "rb") as f:
        line = f.readline().strip()
        if line != b"ply":
            raise ValueError("not a PLY file")
        fmt = None
        count = 0
        props: list[Tuple[str, str]] = []
        in_vertex = False
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unterminated PLY header")
            tokens = line.strip().decode("ascii").split()
            if not tokens:
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "element":
                in_vertex = tokens[1] == "vertex"
                if in_vertex:
                    count = int(tokens[2])
            elif tokens[0] == "property" and in_vertex:
                props.append((tokens[2], _PLY_DTYPES[tokens[1]]))
            elif tokens[0] == "end_header":
                break
        dtype = np.dtype([(n, "<" + t) for n, t in props])
        if fmt == "binary_little_endian":
            data = np.frombuffer(f.read(dtype.itemsize * count), dtype=dtype)
        elif fmt == "ascii":
            rows = np.loadtxt(f, max_rows=count, ndmin=2)
            data = np.zeros(count, dtype=dtype)
            for i, (n, _) in enumerate(props):
                data[n] = rows[:, i]
        else:
            raise ValueError(f"unsupported PLY format {fmt}")
    return {n: np.ascontiguousarray(data[n]) for n, _ in props}


def write_ply(
    path: str,
    xyz: np.ndarray,
    rgb: Optional[np.ndarray] = None,
    normals: Optional[np.ndarray] = None,
    extra: Optional[Dict[str, np.ndarray]] = None,
) -> None:
    """Write a binary-little-endian vertex PLY: x y z nx ny nz, then red
    green blue (u8) with ``rgb``, then each ``extra`` array as one float
    property (``name``) or one per column (``name_0``, ``name_1``, ...)."""
    n = len(xyz)
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    cols = [np.asarray(xyz, dtype=np.float32)]
    if normals is None:
        normals = np.zeros_like(xyz)
    fields += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
    cols.append(np.asarray(normals, dtype=np.float32))
    if rgb is not None:
        fields += [("red", "<u1"), ("green", "<u1"), ("blue", "<u1")]
        cols.append(np.asarray(rgb, dtype=np.uint8))
    for name, arr in (extra or {}).items():
        arr = np.asarray(arr, dtype=np.float32).reshape(n, -1)
        if arr.shape[1] == 1:
            fields.append((name, "<f4"))
        else:
            fields += [(f"{name}_{i}", "<f4") for i in range(arr.shape[1])]
        cols.append(arr)
    dtype = np.dtype(fields)
    out = np.empty(n, dtype=dtype)
    names = iter(dtype.names)
    for col in cols:
        col2d = col.reshape(n, -1)
        for j in range(col2d.shape[1]):
            out[next(names)] = col2d[:, j]
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {n}\n".encode("ascii"))
        for name, dt in fields:
            f.write(f"property {_INV_DTYPES[dt[1:]]} {name}\n".encode("ascii"))
        f.write(b"end_header\n")
        f.write(out.tobytes())
