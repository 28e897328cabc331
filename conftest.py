"""Session settings for pytest runs in this repository.

A process that loads the JAX reference (``tests/conftest.py`` imports it
and pins it to the CPU) gets a JAX compilation cache of its own: the
reference's eager ``jax.shard_map`` recompiles identical small programs on
every call, and the cache compiles each once. The directory is fresh for
each process, lies under the temp dir, and is removed when the session
ends, so every run starts cold. Processes that never import JAX (the
port's and the benchmark's own tests) are left as they are."""

import shutil
import sys
import tempfile

_CACHE_SETTINGS: dict = {}


def pytest_configure(config):
    jax = sys.modules.get("jax")
    if jax is None:
        return
    cache_dir = tempfile.mkdtemp(prefix="jax_cc_")
    config.add_cleanup(lambda: shutil.rmtree(cache_dir, ignore_errors=True))
    _CACHE_SETTINGS.update({
        "jax_compilation_cache_dir": cache_dir,
        "jax_persistent_cache_min_compile_time_secs": 0.0,
        "jax_persistent_cache_min_entry_size_bytes": -1,
    })
    _apply(jax)


def pytest_runtest_setup(item):
    # A test that changes these settings (``__graft_entry__.dryrun_multichip``
    # sets a 1 s compile-time threshold) does not change them for the tests
    # after it in its process.
    if _CACHE_SETTINGS:
        _apply(sys.modules["jax"])


def _apply(jax):
    for name, value in _CACHE_SETTINGS.items():
        if getattr(jax.config, name) != value:
            jax.config.update(name, value)
