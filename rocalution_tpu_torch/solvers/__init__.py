"""Iterative and direct solvers, and iteration control."""

from .direct import inversion, lu, lu_factor, qr, qr_factor
from .fixed_point import fixed_point, fixed_point_sweeps
from .iter_ctrl import IterationControl, SolverInfo
from .krylov import cg

__all__ = ["IterationControl", "SolverInfo", "cg", "fixed_point",
           "fixed_point_sweeps", "inversion", "lu", "lu_factor", "qr",
           "qr_factor"]
