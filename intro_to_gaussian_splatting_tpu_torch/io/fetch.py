"""Dataset acquisition (``gstpu-torch fetch``).

The port's copy of the JAX package's ``io/fetch.py``: download one of the
Mip-NeRF-360 release archives with the standard library (resuming a
partial file), print its sha256, unzip it into the target directory. On a
machine without network access it fails with a RuntimeError that points at
the offline substitute, ``io.synthetic.make_colmap_scene``.
"""

from __future__ import annotations

import hashlib
import os
import sys
import zipfile
from typing import Callable, Optional

# The Mip-NeRF-360 release archives (Google Research bucket; public).
DATASETS = {
    "360_extra": ("https://storage.googleapis.com/gresearch/refraw360/"
                  "360_extra_scenes.zip"),
    "360": ("https://storage.googleapis.com/gresearch/refraw360/360_v2.zip"),
}
# treehill (the reference benchmark scene) is in the extras archive
DEFAULT_DATASET = "360_extra"


def download(url: str, dest_path: str, timeout: float = 30.0,
             progress: Optional[Callable[[int, int], None]] = None,
             _urlopen=None) -> str:
    """Stream ``url`` to ``dest_path`` (resuming a partial file through an
    HTTP Range request when the server honours it). Returns the sha256 hex
    digest of the complete file. ``_urlopen`` is injectable for tests."""
    import urllib.request

    urlopen = _urlopen or urllib.request.urlopen
    tmp = dest_path + ".part"
    start = os.path.getsize(tmp) if os.path.exists(tmp) else 0
    req = urllib.request.Request(url)
    if start:
        req.add_header("Range", f"bytes={start}-")
    mode = "ab" if start else "wb"
    with urlopen(req, timeout=timeout) as resp:
        if start and resp.status != 206:   # the server ignored the Range
            start, mode = 0, "wb"
        total = start + int(resp.headers.get("Content-Length") or 0)
        with open(tmp, mode) as f:
            got = start
            while True:
                chunk = resp.read(1 << 20)
                if not chunk:
                    break
                f.write(chunk)
                got += len(chunk)
                if progress:
                    progress(got, total)
    os.replace(tmp, dest_path)
    h = hashlib.sha256()
    with open(dest_path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def fetch_dataset(name: str = DEFAULT_DATASET, out_dir: str = ".",
                  keep_zip: bool = False, _urlopen=None) -> str:
    """Download and extract one of the known datasets into ``out_dir``;
    returns ``out_dir``. Raises RuntimeError, naming the offline substitute,
    when the download fails."""
    if name not in DATASETS:
        raise ValueError(f"unknown dataset {name!r}; "
                         f"known: {sorted(DATASETS)}")
    url = DATASETS[name]
    os.makedirs(out_dir, exist_ok=True)
    zip_path = os.path.join(out_dir, os.path.basename(url))
    if not os.path.exists(zip_path):
        try:
            digest = download(url, zip_path, _urlopen=_urlopen,
                              progress=_stderr_progress)
            print(f"sha256 {digest}  {zip_path}", file=sys.stderr)
        except Exception as e:
            raise RuntimeError(
                f"download failed ({e!r}). If this machine has no network "
                f"access, generate a synthetic scene instead: python -c "
                f"\"from intro_to_gaussian_splatting_tpu_torch.io.synthetic "
                f"import make_colmap_scene; "
                f"make_colmap_scene('{out_dir}/synthetic', "
                f"write_images=True)\"") from e
    with zipfile.ZipFile(zip_path) as z:
        z.extractall(out_dir)
    if not keep_zip:
        os.remove(zip_path)
    return out_dir


def _stderr_progress(got: int, total: int) -> None:
    if total:
        print(f"\r{got / 1e6:.1f}/{total / 1e6:.1f} MB", end="",
              file=sys.stderr, flush=True)
