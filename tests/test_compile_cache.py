"""The root conftest.py's JAX compilation cache: set in this process, fresh
under the temp directory, kept from subprocesses, and hit by a recompile
of the same program."""

import logging
import os
import pathlib
import tempfile

import jax
import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[1]


def _cache_dir():
    return pathlib.Path(jax.config.jax_compilation_cache_dir).resolve()


def test_each_process_has_its_own_cache_dir():
    cache = _cache_dir()
    assert cache.is_dir()
    assert cache.name.startswith("gstpu-jax-cache-")
    assert cache.is_relative_to(pathlib.Path(tempfile.gettempdir()).resolve())
    assert not cache.is_relative_to(REPO)
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 0
    assert jax.config.jax_persistent_cache_min_entry_size_bytes == 0
    # The subprocesses a test starts do not share this process's directory.
    assert "JAX_COMPILATION_CACHE_DIR" not in os.environ


def test_a_recompile_hits_the_cache(caplog):
    cache = _cache_dir()
    f = jax.jit(lambda x: x * 3.0 + 1.0)
    x = np.arange(7 * 13, dtype=np.float32).reshape(7, 13)
    before = set(cache.iterdir())
    first = np.asarray(f(x))
    added = set(cache.iterdir()) - before
    jax.clear_caches()
    with caplog.at_level(logging.DEBUG, logger="jax._src.compiler"):
        again = np.asarray(f(x))
    assert len(added) == 1
    assert set(cache.iterdir()) == before | added
    assert "Persistent compilation cache hit" in caplog.text
    np.testing.assert_array_equal(again, first)
