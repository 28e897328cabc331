"""Iterative and direct solvers, and iteration control."""

from .chebyshev import chebyshev
from .direct import inversion, lu, lu_factor, qr, qr_factor
from .fixed_point import fixed_point, fixed_point_sweeps
from .iter_ctrl import IterationControl, SolverInfo
from .krylov import (bicgstab, bicgstabl, cg, cr, fcg, fgmres, gmres, idr,
                     qmrcgstab)
from .mixed_precision import mixed_precision_dc

__all__ = ["IterationControl", "SolverInfo", "bicgstab", "bicgstabl", "cg",
           "chebyshev", "cr", "fcg", "fgmres", "fixed_point",
           "fixed_point_sweeps", "gmres", "idr", "inversion", "lu",
           "lu_factor", "mixed_precision_dc", "qmrcgstab", "qr", "qr_factor"]
