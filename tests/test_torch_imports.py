"""Import hygiene of the port: it never imports jax, rocalution_tpu or
ml_dtypes (the bfloat16 plans keep f32 host arrays and cast with torch),
and importing it builds no kernel and no native library."""

import ast
import pathlib
import subprocess
import sys

import rocalution_tpu_torch as rt

PKG = pathlib.Path(rt.__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "rocalution_tpu", "ml_dtypes")

_PROBE = """
import sys
import rocalution_tpu_torch
from rocalution_tpu_torch import interop
from rocalution_tpu_torch.formats import (bcsr, convert, coo, dense, ell, hyb,
                                          mcsr, stencil, wjd_cache)
from rocalution_tpu_torch.io import binary, mtx, rocsparseio
from rocalution_tpu_torch.ops import blas1
from rocalution_tpu_torch.utils import generators
from rocalution_tpu_torch.ops.cuda import _build, spmv_wjd
from rocalution_tpu_torch import native
from rocalution_tpu_torch.ops import (extract, factorize, ordering, spgemm,
                                      trisolve)
from rocalution_tpu_torch.precond import (ai, block, gs, ilu, jacobi, me,
                                          multicolored)
from rocalution_tpu_torch.solvers import mixed_precision
from rocalution_tpu_torch.solvers.krylov import (bicgstab, bicgstabl, cr,
                                                 fcg, gmres, idr, qmrcgstab)
from rocalution_tpu_torch.solvers import chebyshev
from rocalution_tpu_torch.ops import spectral
from rocalution_tpu_torch.solvers import direct, fixed_point, multigrid
from rocalution_tpu_torch.solvers.multigrid import (aggregation,
                                                    aggregation_device, base,
                                                    rs)
from rocalution_tpu_torch.utils import log
bad = sorted(m for m in sys.modules if m.split('.')[0] in {forbidden!r})
print(bad)
sys.exit(1 if bad or _build._loaded or native._TRIED else 0)
"""


def test_import_loads_no_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE.format(forbidden=set(FORBIDDEN))],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_module_names_jax():
    for path in sorted(PKG.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_public_surface():
    for name in ("CSR", "COO", "ELL", "DIA", "HYB", "BCSR", "MCSR", "DENSE",
                 "WJD", "convert", "to_csr", "cast_values", "wjd_spmv",
                 "wjd_spmm", "attach_wjd", "spmv", "cg", "jacobi",
                 "IterationControl", "SolverInfo", "laplacian_2d",
                 "laplacian_3d", "random_banded_spd", "info", "sync",
                 "set_default_device", "fixed_point", "fixed_point_sweeps",
                 "qr", "qr_factor", "lu", "lu_factor", "inversion",
                 "gmres", "fgmres", "mixed_precision_dc", "ilu", "ic",
                 "itilu0", "convection_diffusion_2d", "fem_2d_unstructured",
                 "cr", "fcg", "bicgstab", "bicgstabl", "idr", "qmrcgstab",
                 "chebyshev", "gershgorin", "power_method",
                 "Stencil", "laplace2d_stencil", "laplace3d_stencil",
                 "spmv_add", "io", "blas1", "anisotropic_laplacian_2d",
                 "ComplexWJD"):
        assert hasattr(rt, name), name


def test_item_9_surface():
    """The JAX package's names of ROADMAP item 9: IO (every reader and
    writer but the global pair, which waits for the distributed layer),
    BLAS-1's 27 functions, the generators, the stencil and the plan
    cache."""
    import rocalution_tpu_torch.formats.wjd_cache as cache
    from rocalution_tpu_torch.ops import blas1
    from rocalution_tpu_torch.utils import generators

    for mod, names in (
            (rt.io, ("read_csr", "read_mtx", "read_mtx_vector",
                     "read_rocsparseio", "read_vector",
                     "read_vector_rocsparseio", "write_csr", "write_mtx",
                     "write_rocsparseio", "write_vector",
                     "write_vector_rocsparseio")),
            (blas1, ("dot", "dot_nonconj", "norm", "asum", "amax",
                     "reduce_sum", "scale", "add_scale", "scale_add",
                     "scale_add_scale", "scale_add2", "pointwise_mult",
                     "power", "inclusive_sum", "exclusive_sum", "permute",
                     "permute_backward", "get_index_values",
                     "set_index_values", "add_index_values", "sigma_norm",
                     "restriction", "prolongation", "set_random_uniform",
                     "set_random_normal", "extract_coarse_mapping",
                     "extract_coarse_boundary", "amax_value")),
            (generators, ("anisotropic_laplacian_2d", "permuted_identity",
                          "random_spd", "laplacian_2d_block",
                          "laplacian_3d_block")),
            (rt.formats, ("Stencil", "laplace2d_stencil",
                          "laplace3d_stencil", "ComplexWJD")),
            (cache, ("PLAN_VERSION", "cache_dir", "plan_key", "load_plan",
                     "save_plan"))):
        for name in names:
            assert hasattr(mod, name), (mod.__name__, name)
    assert not hasattr(rt.io, "read_global_csr")


def test_multigrid_surface():
    from rocalution_tpu_torch.solvers import multigrid

    for name in ("amg_hierarchy", "amg_precond", "saamg", "uaamg",
                 "pairwise_amg", "cycle_closure", "convert_hierarchy",
                 "build_hierarchy", "mg_solve", "rebuild_hierarchy_numeric",
                 "make_galerkin_plans", "sa_level", "ua_level",
                 "pairwise_level"):
        assert hasattr(multigrid, name), name


def test_slice_surface():
    """The factorization slice: orderings, factorizations, tri-solves."""
    from rocalution_tpu_torch.ops import factorize, ordering, trisolve

    for mod, names in ((ordering, ("rcmk", "cmk", "permute_csr")),
                       (factorize, ("ilu0", "ic0")),
                       (trisolve, ("LevelSchedule", "build_schedule",
                                   "solve_schedule", "prepare_offd",
                                   "trisolve_jacobi"))):
        for name in names:
            assert hasattr(mod, name), (mod.__name__, name)


def test_preconditioner_and_rs_surface():
    """The JAX package's preconditioner exports (precond/__init__.py), the
    extraction and ordering ops, and Ruge-Stüben AMG."""
    from rocalution_tpu_torch.ops import extract, factorize, ordering
    from rocalution_tpu_torch.solvers import multigrid

    for mod, names in (
            (rt.precond, ("additive_schwarz", "aichebyshev", "backward_gs",
                          "block_jacobi", "block_precond", "bsr_ic0",
                          "bsr_ilu0", "fsai", "gs", "ic", "ilu",
                          "ilut_precond", "itilu0", "jacobi",
                          "multi_elimination", "multicolored_gs",
                          "multicolored_ilu", "multicolored_sgs",
                          "restricted_additive_schwarz",
                          "saddle_point_precond", "sgs", "sor", "spai",
                          "ssor", "tns", "variable_precond")),
            (extract, ("extract_lower", "extract_upper", "extract_submatrix",
                       "extract_index_submatrix", "extract_submatrices",
                       "scale", "scale_diagonal", "scale_off_diagonal",
                       "add_scalar", "add_scalar_diagonal",
                       "add_scalar_off_diagonal", "compress",
                       "extract_row_vector", "extract_column_vector",
                       "replace_row_vector", "replace_column_vector",
                       "create_from_map")),
            (ordering, ("multicoloring", "maximal_independent_set",
                        "connectivity_order", "zero_block_permutation",
                        "permute_rows_csr")),
            (factorize, ("ilup", "ilut", "bsrilu0", "bsric0")),
            (multigrid, ("rsamg", "rs_level"))):
        for name in names:
            assert hasattr(mod, name), (mod.__name__, name)


def test_default_device_is_explicit():
    """Constructors build on "cuda" unless told otherwise; the setting is
    not probed, so it holds on a machine without a card too."""
    import torch

    before = rt.config.default_device()
    assert before == torch.device("cuda")
    assert rt.config.Config().default_device == torch.device("cuda")
    rt.set_default_device("meta")
    try:
        assert rt.laplacian_2d(3).data.device == torch.device("meta")
    finally:
        rt.set_default_device(before)
    assert rt.config.default_device() == torch.device("cuda")


def test_constructor_on_the_cpu_needs_no_card():
    import numpy as np
    import torch

    cpu = torch.device("cpu")
    A = rt.laplacian_2d(3, device="cpu")
    assert A.data.device == cpu
    for fmt in ("COO", "ELL", "DIA", "HYB", "BCSR", "MCSR", "DENSE", "WJD"):
        assert rt.convert(A, fmt).device == cpu, fmt
    assert rt.CSR.from_dense(np.eye(3), device="cpu").device == cpu
    assert rt.COO.from_dense(np.eye(3), device="cpu").device == cpu
    assert rt.DENSE.from_array(np.eye(3), device="cpu").device == cpu


def test_constructor_without_a_card_raises():
    """No quiet fallback to the CPU: without a card and without
    device="cpu", torch's own error comes through."""
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((AssertionError, RuntimeError)):
        rt.laplacian_2d(3)
