"""rocalution_tpu_torch — the PyTorch/CUDA port of rocalution_tpu.

The JAX package (rocalution_tpu) stays the reference; this package
mirrors its layout and names. Ported so far: the storage formats (CSR,
COO, ELL, DIA, HYB, BCSR, MCSR, DENSE, WJD) and their conversions, SpMV
and SpMM for all of them (with hand-written Hopper kernels for WJD,
ops/cuda/), BLAS-1, SpGEMM and the Galerkin product (ops/spgemm.py),
IterationControl, CG, FixedPoint, the dense direct solvers (QR, LU,
inversion), the Jacobi preconditioner, and multigrid: SA, UA and pairwise
AMG hierarchies with V, W, F and K cycles (solvers/multigrid), set up on
the host through the native layer (native/) and cycled on the device of
the fine operator. It imports torch, numpy and scipy and never jax.
Constructors build on the card ("cuda") unless the caller passes
``device="cpu"`` or calls ``set_default_device("cpu")``.
"""

from . import backend, config
from .backend import info, init, stop, sync
from .config import set_auto_wjd, set_default_device, set_default_dtype
from .formats import (BCSR, COO, CSR, DENSE, DIA, ELL, HYB, MCSR, WJD,
                      cast_values, convert, to_csr)
from .ops.cuda.spmv_wjd import wjd_spmm, wjd_spmv
from .ops.spmv import attach_wjd, spmv
from .precond.jacobi import jacobi
from .solvers import (IterationControl, SolverInfo, cg, fixed_point,
                      fixed_point_sweeps, inversion, lu, lu_factor, qr,
                      qr_factor)
from .utils.generators import laplacian_2d, laplacian_3d, random_banded_spd

__all__ = [
    "CSR", "COO", "ELL", "DIA", "HYB", "BCSR", "MCSR", "DENSE", "WJD",
    "convert", "to_csr", "cast_values", "spmv", "wjd_spmv", "wjd_spmm",
    "attach_wjd", "cg", "fixed_point", "fixed_point_sweeps", "qr",
    "qr_factor", "lu", "lu_factor", "inversion", "jacobi",
    "IterationControl", "SolverInfo", "laplacian_2d", "laplacian_3d",
    "random_banded_spd", "info", "init", "stop", "sync",
    "set_default_device", "set_default_dtype", "set_auto_wjd", "backend",
    "config",
]

__version__ = "0.1.0"
