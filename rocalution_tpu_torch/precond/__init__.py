"""Preconditioners ported so far: Jacobi, ILU(0), IC(0), ItILU0."""

from .ilu import ic, ilu, itilu0
from .jacobi import jacobi

__all__ = ["ic", "ilu", "itilu0", "jacobi"]
