"""Krylov solvers ported so far: CG, GMRES, FGMRES."""

from .cg import cg
from .gmres import fgmres, gmres

__all__ = ["cg", "fgmres", "gmres"]
