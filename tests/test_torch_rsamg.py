"""Port parity: Ruge-Stüben AMG (strength, PMIS and greedy C/F
splitting, direct and extended+i interpolation, rs_level, kind="rs"
hierarchies) and the device PMIS loops
(aggregation and C/F splitting, "pmis-device" in sa_level and rs_level),
run here on the CPU.

The setup is host code copied from the JAX package, with numpy's
default_rng draws, and the same native greedy sweep: C/F maps and
aggregates are equal arrays, P/R/Ac equal patterns with values within
rtol 1e-13. The device loops are torch ops where the JAX package has
`lax.while_loop`s: their aggregates and C/F maps are equal arrays too.
CG + RS-AMG, `cg_rsamg.py`'s four combinations, is in
test_torch_rsamg_samples.py.
"""

import re

import numpy as np
import pytest
import torch

import rocalution_tpu as jrt
import rocalution_tpu_torch as rt
from rocalution_tpu import native as jax_native
from rocalution_tpu.solvers import multigrid as jmg
from rocalution_tpu.solvers.multigrid import aggregation_device as jax_dev
from rocalution_tpu.solvers.multigrid import rs as jax_rs
from rocalution_tpu_torch import native
from rocalution_tpu_torch.solvers import multigrid as tmg
from rocalution_tpu_torch.solvers.multigrid import aggregation as torch_agg
from rocalution_tpu_torch.solvers.multigrid import aggregation_device as dev
from rocalution_tpu_torch.solvers.multigrid import rs
from test_torch_native import natives_loaded  # noqa: F401  (autouse)
from test_torch_native import plan_cache_off  # noqa: F401  (autouse)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    before = rt.config.default_device()
    rt.set_default_device("cpu")
    yield
    rt.set_default_device(before)


def _triplets_equal(Mj, Mt, what=""):
    """Equal shapes and patterns, values within rtol 1e-13."""
    assert Mj.shape == Mt.shape, what
    for a, b in zip(Mj.numpy_triplet(), Mt.numpy_triplet()):
        assert a.dtype == b.dtype, what
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=1e-13, atol=0,
                                       err_msg=what)
        else:
            np.testing.assert_array_equal(a, b, err_msg=what)


OPS = {
    "lap2d_24": lambda m: m.laplacian_2d(24),
    "lap3d_10": lambda m: m.laplacian_3d(10),
    "cd2d_16": lambda m: m.convection_diffusion_2d(16),
}


@pytest.fixture(scope="module")
def ops():
    out = {}
    for name, make in OPS.items():
        Aj, At = make(jrt), make(rt)
        S = rs._scipy(At)
        out[name] = (Aj, At, S, rs.classical_strength(S))
    return out


def test_strength_and_cf_splittings_match_jax(ops):
    for name, (_, _, S, Sg) in ops.items():
        for theta in (0.25, 0.5):
            Cj, Ct = jax_rs.classical_strength(S, theta), \
                rs.classical_strength(S, theta)
            assert (Cj != Ct).nnz == 0, name
        for seed in (0, 3):
            np.testing.assert_array_equal(jax_rs.pmis_coarsening(Sg, seed),
                                          rs.pmis_coarsening(Sg, seed),
                                          err_msg=name)
        for second in (True, False):
            np.testing.assert_array_equal(
                jax_rs.greedy_coarsening(Sg, second),
                rs.greedy_coarsening(Sg, second), err_msg=name)


def test_greedy_fallback_matches_jax(ops, monkeypatch):
    """The Python sweep both packages take without the native layer."""
    _, _, _, Sg = ops["lap2d_24"]
    monkeypatch.setattr(jax_native, "available", lambda: False)
    monkeypatch.setattr(native, "available", lambda: False)
    np.testing.assert_array_equal(jax_rs.greedy_coarsening(Sg),
                                  rs.greedy_coarsening(Sg))


@pytest.mark.parametrize("coarsening", ["pmis", "greedy", "pmis-device"])
def test_rs_level_matches_jax(ops, coarsening):
    """Where the JAX package raises, the port raises the same error: on
    cd2d_16, ExtPI with the FF1 limit over the device PMIS split of seed 2
    gives a coarse column index of -1 to the P assembly in both packages,
    and scipy rejects it (ROADMAP.md section 3 fault 10)."""
    for interp in ("direct", "extpi", "extpi_ff1"):
        kw = dict(coarsening=coarsening,
                  interpolation=interp.split("_")[0],
                  ff1_limit=interp.endswith("ff1"), seed=2)
        for name in ("lap2d_24", "cd2d_16"):
            Aj, At, _, _ = ops[name]
            try:
                want = jax_rs.rs_level(Aj, **kw)
            except ValueError as e:
                with pytest.raises(ValueError, match=re.escape(str(e))):
                    rs.rs_level(At, **kw)
                continue
            for what, Mj, Mt in zip("PRA", want, rs.rs_level(At, **kw)):
                _triplets_equal(Mj, Mt, f"{name} {interp} {what}")
                assert Mt.device == torch.device("cpu")  # host-resident


def test_device_pmis_matches_jax(ops):
    for name, (_, _, S, Sg) in ops.items():
        C = torch_agg.strength_connect(S)
        for seed in (0, 5):
            np.testing.assert_array_equal(
                jax_dev.pmis_coarsening_device(Sg, seed),
                dev.pmis_coarsening_device(Sg, seed, "cpu"), err_msg=name)
            np.testing.assert_array_equal(
                jax_dev.pmis_aggregate_jit(C, seed),
                dev.pmis_aggregate_jit(C, seed, "cpu"), err_msg=name)


def test_device_pmis_aggregate_keeps_the_jax_contract():
    """Isolated nodes and an empty graph, as the JAX package."""
    import scipy.sparse as sp

    C = sp.csr_matrix((np.ones(4, np.int8), ([0, 1, 3, 4], [1, 0, 4, 3])),
                      shape=(6, 6))
    np.testing.assert_array_equal(jax_dev.pmis_aggregate_jit(C, 1),
                                  dev.pmis_aggregate_jit(C, 1, "cpu"))
    E = sp.csr_matrix((5, 5), dtype=np.int8)
    np.testing.assert_array_equal(dev.pmis_aggregate_jit(E), np.arange(5))


@pytest.mark.parametrize("kind,kw", [
    ("rs", dict(coarsening="pmis", interpolation="extpi")),
    ("rs", dict(coarsening="greedy", interpolation="direct")),
    ("rs", dict(coarsening="pmis-device", interpolation="direct")),
    ("sa", dict(strategy="pmis-device")),
    ("ua", dict(strategy="pmis-device"))])
def test_hierarchies_match_jax(ops, kind, kw):
    """Every level: the seed follows the level, as in the JAX package."""
    Aj, At, _, _ = ops["lap3d_10"]
    hj = jmg.amg_hierarchy(Aj, kind, coarse_size=40, **kw)
    ht = tmg.amg_hierarchy(At, kind, coarse_size=40, **kw)
    assert ht.operator_sizes() == hj.operator_sizes()
    assert ht.num_levels >= 3
    for lj, lt in zip(hj.levels, ht.levels):
        for what in "APR":
            if getattr(lj, what) is not None:
                _triplets_equal(getattr(lj, what), getattr(lt, what), what)
