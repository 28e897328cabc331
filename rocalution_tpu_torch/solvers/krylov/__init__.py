"""Krylov solvers: CG, CR, FCG, BiCGStab, BiCGStab(l), IDR(s), QMRCGStab,
GMRES and FGMRES."""

from .bicgstab import bicgstab
from .bicgstabl import bicgstabl
from .cg import cg
from .cr import cr
from .fcg import fcg
from .gmres import fgmres, gmres
from .idr import idr
from .qmrcgstab import qmrcgstab

__all__ = ["bicgstab", "bicgstabl", "cg", "cr", "fcg", "fgmres", "gmres",
           "idr", "qmrcgstab"]
