"""The test session's JAX compilation cache (the repository's root
``conftest.py``): the JAX reference's eager ``shard_map`` compiles every
primitive as its own program on each call, and JAX's in-memory caches key
on closures that are new each time. Without the cache the distributed AMG
tests run for tens of minutes."""

import pathlib
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from rocalution_tpu.parallel import make_mesh

NP = 4
# A shape no other test compiles, so the first call below has programs of
# its own to compile, whichever tests ran before it in this process.
SHAPE = (NP * 7, 19)

REQUESTS = "/jax/compilation_cache/compile_requests_use_cache"
HITS = "/jax/compilation_cache/cache_hits"


def test_repeated_eager_shard_map_compiles_nothing_new():
    assert jax.config.jax_compilation_cache_dir, "no compilation cache"
    cache_dir = pathlib.Path(jax.config.jax_compilation_cache_dir)
    assert cache_dir.is_relative_to(tempfile.gettempdir())
    assert cache_dir.is_dir()

    mesh = make_mesh(NP)
    x = jnp.arange(np.prod(SHAPE), dtype=jnp.float32).reshape(SHAPE)

    def eager_call():
        # A new closure on every call, as the reference's solve loop makes.
        fn = jax.shard_map(
            lambda xs: xs * jax.lax.psum(jnp.sum(xs), "p") - 2.5 * xs,
            mesh=mesh, in_specs=P("p"), out_specs=P("p"))
        return np.asarray(fn(x))

    events = []

    def listen(event, **kwargs):
        if event in (REQUESTS, HITS):
            events.append(event)

    jax.monitoring.register_event_listener(listen)
    try:
        files = set(cache_dir.iterdir())
        first = eager_call()
        misses_first = events.count(REQUESTS) - events.count(HITS)
        added_first = set(cache_dir.iterdir()) - files
        events.clear()
        second = eager_call()
        misses_second = events.count(REQUESTS) - events.count(HITS)
        added_second = set(cache_dir.iterdir()) - files - added_first
    finally:
        jax.monitoring.unregister_event_listener(listen)

    assert misses_first > 0, "the first call compiled nothing through the cache"
    assert added_first, "the first call wrote nothing to the cache"
    assert misses_second == 0, f"the repeat compiled {misses_second} programs"
    assert not added_second
    np.testing.assert_array_equal(second, first)
