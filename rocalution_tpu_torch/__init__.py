"""rocalution_tpu_torch — the PyTorch/CUDA port of rocalution_tpu.

The JAX package (rocalution_tpu) stays the reference; this package
mirrors its layout and names. Ported so far: the storage formats (CSR,
COO, ELL, DIA, HYB, BCSR, MCSR, DENSE, WJD) and their conversions, SpMV
and SpMM for all of them (with hand-written Hopper kernels for WJD,
ops/cuda/), BLAS-1, SpGEMM and the Galerkin product (ops/spgemm.py),
IterationControl, the Krylov solvers (CG, CR, FCG, BiCGStab, BiCGStab(l),
IDR(s), QMRCGStab, GMRES, FGMRES), Chebyshev with Gershgorin bounds and
the power method, FixedPoint, MixedPrecisionDC, the
dense direct solvers (QR, LU, inversion), the whole preconditioner stack
of the JAX package (precond/: Jacobi, GS/SGS/SOR/SSOR, multicoloured
GS/SGS/ILU, ILU(p), IC(0), ILUT, ItILU0, BSR-ILU(0)/IC(0), FSAI, SPAI,
TNS, AIChebyshev, BlockJacobi, BlockPreconditioner, AS/RAS,
MultiElimination, VariablePreconditioner, saddle point; set up on the
host, factorizations through the native layer, applied by level-scheduled
or Jacobi-swept tri-solves, ops/trisolve.py, and SpMV chains), the
orderings and extraction ops (ops/ordering.py, ops/extract.py), and
multigrid: SA, UA, pairwise and Ruge-Stüben AMG hierarchies with V, W, F
and K cycles (solvers/multigrid), set up on the host through the native
layer (native/), PMIS optionally on the device, and cycled on the device
of the fine operator; complex operators (a ComplexWJD of two real planes
through the same kernels), matrix-free stencils (Stencil), the on-disk
plan cache (formats/wjd_cache.py) and IO (io/: MatrixMarket, the binary
container, rocsparseio), the runtime switches (`get_config`,
`set_verbose`, `set_debug`), utils (`key`, `log`, `profile`, `validate`)
and the benchmark CLI (bench_cli.py). It imports torch, numpy and scipy
and never jax.
Constructors build on the card ("cuda") unless the caller passes
``device="cpu"`` or calls ``set_default_device("cpu")``.
"""

from . import backend, config, io, ops, precond, utils
from .backend import info, init, stop, sync
from .config import (get_config, set_auto_wjd, set_debug, set_default_device,
                     set_default_dtype, set_verbose)
from .formats import (BCSR, COO, CSR, DENSE, DIA, ELL, HYB, MCSR, WJD,
                      ComplexWJD, Stencil, cast_values, convert,
                      laplace2d_stencil, laplace3d_stencil, to_csr)
from .ops import blas1
from .ops.cuda.spmv_wjd import wjd_spmm, wjd_spmv
from .ops.spectral import gershgorin, power_method
from .ops.spmv import attach_wjd, spmv, spmv_add
from .precond import ic, ilu, itilu0, jacobi
from .solvers import (IterationControl, SolverInfo, bicgstab, bicgstabl, cg,
                      chebyshev, cr, fcg, fgmres, fixed_point,
                      fixed_point_sweeps, gmres, idr, inversion, lu,
                      lu_factor, mixed_precision_dc, qmrcgstab, qr,
                      qr_factor)
from .utils.generators import (anisotropic_laplacian_2d,
                               convection_diffusion_2d, fem_2d_unstructured,
                               laplacian_2d, laplacian_3d, random_banded_spd)

__all__ = [
    "CSR", "COO", "ELL", "DIA", "HYB", "BCSR", "MCSR", "DENSE", "WJD",
    "ComplexWJD", "Stencil", "laplace2d_stencil", "laplace3d_stencil",
    "convert", "to_csr", "cast_values", "spmv", "spmv_add", "wjd_spmv",
    "wjd_spmm", "attach_wjd", "blas1", "io", "ops", "utils", "cg", "cr", "fcg", "bicgstab", "bicgstabl", "idr",
    "qmrcgstab", "chebyshev", "gershgorin", "power_method", "gmres",
    "fgmres", "mixed_precision_dc",
    "fixed_point", "fixed_point_sweeps", "qr", "qr_factor", "lu",
    "lu_factor", "inversion", "jacobi", "ilu", "ic", "itilu0",
    "IterationControl", "SolverInfo", "laplacian_2d", "laplacian_3d",
    "convection_diffusion_2d", "fem_2d_unstructured", "random_banded_spd",
    "anisotropic_laplacian_2d",
    "info", "init", "stop", "sync",
    "set_default_device", "set_default_dtype", "set_auto_wjd", "backend",
    "get_config", "set_debug", "set_verbose",
    "config", "precond",
]

__version__ = "0.1.0"
