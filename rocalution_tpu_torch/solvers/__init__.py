"""Iterative and direct solvers, and iteration control."""

from .direct import inversion, lu, lu_factor, qr, qr_factor
from .fixed_point import fixed_point, fixed_point_sweeps
from .iter_ctrl import IterationControl, SolverInfo
from .krylov import cg, fgmres, gmres
from .mixed_precision import mixed_precision_dc

__all__ = ["IterationControl", "SolverInfo", "cg", "fgmres", "fixed_point",
           "fixed_point_sweeps", "gmres", "inversion", "lu", "lu_factor",
           "mixed_precision_dc", "qr", "qr_factor"]
