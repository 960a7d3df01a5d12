"""Each test process gets its own JAX compilation cache, empty at start.

The eager ``shard_map`` path of the sharding tests builds the same small
programs many times under new Python objects, so JAX's in-memory caches
miss; the persistent cache keys on the lowered program and hits. The
programs compile in well under JAX's 1 s threshold, hence the zero
minimums. The directory is made here, in one process, and removed when it
ends, so nothing carries between workers, runs or machines. The variables
are taken out again once JAX has read them, so that the subprocesses a
test starts run without a cache, as before.
"""

import os
import shutil
import sys
import tempfile

_CACHE = {
    "jax_compilation_cache_dir": tempfile.mkdtemp(prefix="gstpu-jax-cache-"),
    "jax_persistent_cache_min_compile_time_secs": 0,
    "jax_persistent_cache_min_entry_size_bytes": 0,
}
os.environ.update({k.upper(): str(v) for k, v in _CACHE.items()})
if "jax" in sys.modules:  # imported before this file: the variables come late
    for _k, _v in _CACHE.items():
        sys.modules["jax"].config.update(_k, _v)


def pytest_configure(config):
    # tests/conftest.py has imported JAX by now.
    for k in _CACHE:
        os.environ.pop(k.upper(), None)


def pytest_unconfigure(config):
    shutil.rmtree(_CACHE["jax_compilation_cache_dir"], ignore_errors=True)
