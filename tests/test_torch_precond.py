"""Port parity: the setup side of the rest of the preconditioner stack
(extraction ops, orderings, ILU(p), ILUT, the BCSR factorizations, the
FSAI and SPAI matrices); the applies are in test_torch_precond_apply.py.

Host setup is copied from the JAX package, so extracted matrices,
colourings, independent sets and permutations are equal arrays; factors,
FSAI's G and the SPAI matrix have equal patterns and values within rtol
1e-13 in f64 (1e-6 in f32). The port assembles the FSAI/SPAI batches
with vectorized gathers and batches the BCSR sweeps by row level, where
the JAX package loops; the results are held to the same bars. Cases are
grouped a few a test, which keeps the file's count of tests (the order in
which the test workers take files) below the JAX package's long files.

The JAX package's ILU(p) and ILUT hand f32 value buffers to its f64
native entry points (ROADMAP.md section 3 fault 9: garbage or a heap
overflow), so the port's f32 factors are held to the JAX package's f64
factors of the same f32 values, rounded to f32: the port runs the native
sweep in f64 and casts back, as both packages do for ILU(0).
"""

import numpy as np
import pytest
import torch

import rocalution_tpu as jrt
import rocalution_tpu_torch as rt
from rocalution_tpu.ops import extract as jax_ext
from rocalution_tpu.ops import factorize as jax_fac
from rocalution_tpu.ops import ordering as jax_ord
from rocalution_tpu_torch import precond as tp
from rocalution_tpu_torch.ops import extract, factorize, ordering
from test_torch_native import natives_loaded  # noqa: F401  (autouse)
from test_torch_native import plan_cache_off  # noqa: F401  (autouse)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    before = rt.config.default_device()
    rt.set_default_device("cpu")
    yield
    rt.set_default_device(before)


def _triplets_equal(Mj, Mt, rtol=None, what=""):
    """Equal shapes and patterns; values equal, or within rtol."""
    assert Mj.shape == Mt.shape, what
    for a, b in zip(Mj.numpy_triplet(), Mt.numpy_triplet()):
        assert a.dtype == b.dtype, what
        if rtol is None or a.dtype.kind != "f":
            np.testing.assert_array_equal(a, b, err_msg=what)
        else:
            np.testing.assert_allclose(b, a, rtol=rtol, atol=0,
                                       err_msg=what)


def _close(got, want, rtol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


OPS = {
    "lap2d_12": lambda m: m.laplacian_2d(12),
    "lap3d_8": lambda m: m.laplacian_3d(8),
    "cd2d_16": lambda m: m.convection_diffusion_2d(16),
    "cd2d_16_f32": lambda m: m.convection_diffusion_2d(16, dtype=np.float32),
}


@pytest.fixture(scope="module")
def ops():
    return {name: (make(jrt), make(rt)) for name, make in OPS.items()}


# ---------------------------------------------------------------- extract

EXTRACT = {
    "lower": ("extract_lower", (), {}),
    "strict_upper": ("extract_upper", (), {"diag": False}),
    "submatrix": ("extract_submatrix", (20, 30, 50, 60), {}),
    "scale_diagonal": ("scale_diagonal", (0.5,), {}),
    "scale": ("scale", (-2.0,), {}),
    "scale_off_diagonal": ("scale_off_diagonal", (3.0,), {}),
    "add_scalar": ("add_scalar", (0.25,), {}),
    "add_scalar_diagonal": ("add_scalar_diagonal", (1.5,), {}),
    "add_scalar_off_diagonal": ("add_scalar_off_diagonal", (-0.5,), {}),
    "compress": ("compress", (0.9,), {}),
    "replace_column": ("replace_column_vector", (7, np.arange(144.0) % 5),
                       {}),
    "replace_row": ("replace_row_vector", (9, np.arange(144.0) % 3), {}),
}


def test_extraction_ops_match_jax(ops):
    Aj, At = ops["lap2d_12"]
    for case, (fn, args, kw) in EXTRACT.items():
        _triplets_equal(getattr(jax_ext, fn)(Aj, *args, **kw),
                        getattr(extract, fn)(At, *args, **kw), what=case)


def test_index_submatrices_vectors_and_maps_match_jax(ops):
    Aj, At = ops["cd2d_16"]
    rows, cols = np.arange(40, 90), np.r_[0:10, 50:120]
    _triplets_equal(jax_ext.extract_index_submatrix(Aj, rows, cols),
                    extract.extract_index_submatrix(At, rows, cols))
    for bj, bt in zip(jax_ext.extract_submatrices(Aj, 3),
                      extract.extract_submatrices(At, 3)):
        for Mj, Mt in zip(bj, bt):
            _triplets_equal(Mj, Mt)
    for fn in ("extract_row_vector", "extract_column_vector"):
        np.testing.assert_array_equal(getattr(jax_ext, fn)(Aj, 17),
                                      getattr(extract, fn)(At, 17))
    fmap = np.where(np.arange(256) % 3 == 0, np.arange(256) // 3, -1)
    for Mj, Mt in zip(jax_ext.create_from_map(fmap, 256, 86),
                      extract.create_from_map(fmap, 256, 86)):
        _triplets_equal(Mj, Mt)


# -------------------------------------------------------------- orderings

def test_orderings_match_jax(ops):
    for name in ("lap3d_8", "cd2d_16"):
        Aj, At = ops[name]
        for a, b in zip(jax_ord.multicoloring(Aj),
                        ordering.multicoloring(At)):
            np.testing.assert_array_equal(a, b, err_msg=name)
        for fn in ("maximal_independent_set", "zero_block_permutation"):
            for a, b in zip(getattr(jax_ord, fn)(Aj),
                            getattr(ordering, fn)(At)):
                np.testing.assert_array_equal(a, b, err_msg=name)
        np.testing.assert_array_equal(jax_ord.connectivity_order(Aj),
                                      ordering.connectivity_order(At))
        perm = np.random.default_rng(4).permutation(At.shape[0])
        _triplets_equal(jax_ord.permute_rows_csr(Aj, perm),
                        ordering.permute_rows_csr(At, perm), what=name)


# -------------------------------------------------------------- factors

def _f64_twin(At):
    """The JAX package's CSR of At's values in f64."""
    d, i, p = At.numpy_triplet()
    return jrt.CSR.from_arrays(d.astype(np.float64), i, p, At.shape)


FACTORS = {"ilup1": ("ilup", {"p": 1}), "ilup2": ("ilup", {"p": 2}),
           "ilut": ("ilut", {}),
           "ilut_tight": ("ilut", {"tol": 1e-2, "max_fill": 3})}


@pytest.mark.parametrize("name", ["cd2d_16", "cd2d_16_f32"])
def test_ilup_and_ilut_factors_match_jax(ops, name):
    Aj, At = ops[name]
    f32 = At.dtype == torch.float32
    for case, (fn, kw) in FACTORS.items():
        got = getattr(factorize, fn)(At, **kw)
        want = getattr(jax_fac, fn)(_f64_twin(At) if f32 else Aj, **kw)
        for Fj, Ft in zip(want, got):
            if f32:
                Fj = jrt.CSR.from_arrays(Fj.numpy_triplet()[0].astype(
                    np.float32), *Fj.numpy_triplet()[1:], Fj.shape)
            _triplets_equal(Fj, Ft, rtol=1e-6 if f32 else 1e-13, what=case)
            assert Ft.device == torch.device("cpu")     # host-resident


def test_ilut_without_the_native_layer_matches_jax(ops, monkeypatch):
    from rocalution_tpu import native as jax_native
    from rocalution_tpu_torch import native

    Aj, At = ops["cd2d_16"]
    monkeypatch.setattr(jax_native, "available", lambda: False)
    monkeypatch.setattr(native, "available", lambda: False)
    for Fj, Ft in zip(jax_fac.ilut(Aj, 1e-2, 4), factorize.ilut(At, 1e-2, 4)):
        _triplets_equal(Fj, Ft, rtol=1e-13)


def test_block_factors_match_jax(ops):
    """The port batches the block sweep by row level; the JAX package
    sweeps row by row (its bsric0 also probes every k < j)."""
    for name in ("lap2d_12", "cd2d_16", "cd2d_16_f32"):
        Aj, At = ops[name]
        rtol = 1e-6 if At.dtype == torch.float32 else 1e-13
        Bj, Bt = (m.convert(A, "BCSR", block_dim=2)
                  for m, A in ((jrt, Aj), (rt, At)))
        (lj, uj, dj), (lt, ut, dt) = (jax_fac.bsrilu0(Bj),
                                      factorize.bsrilu0(Bt))
        for a, b in zip(lj + uj + (dj,), lt + ut + (dt,)):
            assert a.dtype == b.dtype, name
            np.testing.assert_allclose(b, a, rtol=rtol, atol=0,
                                       err_msg=name)
        if name == "lap2d_12":
            for a, b in zip(jax_fac.bsric0(Bj), factorize.bsric0(Bt)):
                assert a.dtype == b.dtype
                np.testing.assert_allclose(b, a, rtol=rtol, atol=0)


def test_fsai_and_spai_matrices_match_jax(ops):
    from rocalution_tpu.precond import ai as jax_ai
    from rocalution_tpu_torch.precond import ai

    Aj, At = ops["lap3d_8"]
    for q in (1, 2):
        for Mj, Mt in zip(jax_ai.fsai_matrices(Aj, q),
                          ai.fsai_matrices(At, q)):
            _triplets_equal(Mj, Mt, 1e-13, what=f"FSAI({q})")
    for name in ("lap3d_8", "cd2d_16_f32"):
        Aj, At = ops[name]
        rtol = 1e-6 if At.dtype == torch.float32 else 1e-13
        _triplets_equal(jax_ai.spai_matrix(Aj), ai.spai_matrix(At), rtol,
                        what=name)


def test_multicolouring_bounds_the_levels(ops):
    """A colour-permuted GS solve has one level a colour."""
    _, At = ops["lap3d_8"]
    ncol, _, sizes = ordering.multicoloring(At)
    M = tp.multicolored_gs(At)
    assert M.schedules[0].nlev <= ncol
    assert sizes.sum() == At.shape[0]
