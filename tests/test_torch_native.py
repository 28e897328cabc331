"""Both native setup layers loaded before a parity test compares.

The JAX package builds its native library into one shared path
(``native_<tag>.so.tmp`` in its cache, then ``os.replace``). Test
processes started together on a cold cache race there: the loser's
replace fails, and that process keeps the numpy fallbacks for the rest of
its life (`_TRIED` stays set). Its factors and hierarchies then come from
another path than the port's (the f32 ILU(0)/IC(0) sweep without native
f64, PMIS instead of greedy aggregation above 5000 rows), and a parity
test fails although the port is right. The winner's library is in place
by the time the loser's build has failed, so loading it again succeeds.

Every port test file that compares with a result the JAX package builds
through its native layer imports `natives_loaded` from here, which makes
it autouse there: module-scoped, it loads both layers, reloads the JAX one
where it lost the race, restores the JAX module's globals afterwards, and
asserts that both are available.
"""

import shutil

import pytest

from rocalution_tpu import native as jax_native
from rocalution_tpu_torch import native
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

RACE = ("the JAX package's native build failed, most likely by losing the "
        "race on its shared .so.tmp path to another test process")


def _load_both(mp):
    if not jax_native.available() and shutil.which("g++"):
        mp.setattr(jax_native, "_TRIED", False)
        mp.setattr(jax_native, "_LIB", None)
        jax_native.get_lib()
    assert jax_native.available(), RACE
    assert native.available(), "the port's native layer did not build"


@pytest.fixture(scope="module", autouse=True)
def plan_cache_off():
    """Both packages' on-disk WJD plan caches off: a parity test compares
    plans made in its own process, and nothing is written under ~. Every
    port test file that plans imports it from here (autouse there)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ROCALUTION_TPU_TORCH_PLAN_CACHE", "0")
        mp.setenv("ROCALUTION_TPU_PLAN_CACHE", "0")
        yield


@pytest.fixture(scope="module", autouse=True)
def natives_loaded():
    with pytest.MonkeyPatch.context() as mp:
        _load_both(mp)
        yield


def test_a_lost_build_race_is_loaded_again(monkeypatch):
    """A process whose JAX native build failed (`_TRIED` set, no library)
    loads the library that is in place, and gets its globals back."""
    lib = jax_native._LIB
    monkeypatch.setattr(jax_native, "_LIB", None)
    assert not jax_native.available()
    with pytest.MonkeyPatch.context() as mp:
        _load_both(mp)
        assert jax_native.available()
        assert jax_native._LIB is not None
    assert jax_native._LIB is None and jax_native._TRIED
    monkeypatch.setattr(jax_native, "_LIB", lib)


def test_both_layers_compute_the_same_ilu0():
    import numpy as np

    import rocalution_tpu_torch as rt

    A = rt.laplacian_2d(6, device="cpu")
    _, i, p = A.numpy_triplet()
    dj, dt = (A.numpy_triplet()[0].copy() for _ in range(2))
    jax_native.ilu0_inplace(p, i.astype(np.int32), dj)
    native.ilu0_inplace(p, i.astype(np.int32), dt)
    np.testing.assert_array_equal(dj, dt)
