"""Scene directory lookup. The full loader with ground-truth images comes
with the training slice."""

from __future__ import annotations

import os


def resolve_sparse(path: str) -> str:
    """Find the COLMAP model dir under ``path`` (accepts the scene root,
    ``sparse`` or ``sparse/0`` itself)."""
    for cand in (path, os.path.join(path, "sparse", "0"),
                 os.path.join(path, "sparse"), os.path.join(path, "0")):
        if os.path.exists(os.path.join(cand, "cameras.bin")) or \
           os.path.exists(os.path.join(cand, "cameras.txt")):
            return cand
    raise FileNotFoundError(f"no COLMAP model found under {path}")
