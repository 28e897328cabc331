"""Preconditioner stack (reference: src/solvers/preconditioners/*).

Counterpart of rocalution_tpu/precond/__init__.py, with the same names.
Every preconditioner is a closure ``r -> z`` built once from the matrix
(setup = the reference's Build(), on the host); the apply runs on the
operator's device.
"""

from .ai import aichebyshev, fsai, spai, tns
from .block import (additive_schwarz, block_jacobi, block_precond,
                    restricted_additive_schwarz)
from .gs import backward_gs, gs, sgs, sor, ssor
from .ilu import bsr_ic0, bsr_ilu0, ic, ilu, ilut_precond, itilu0
from .jacobi import jacobi
from .me import multi_elimination, saddle_point_precond, variable_precond
from .multicolored import multicolored_gs, multicolored_ilu, multicolored_sgs

__all__ = [
    "additive_schwarz", "aichebyshev", "backward_gs", "block_jacobi",
    "block_precond", "bsr_ic0", "bsr_ilu0", "fsai", "gs", "ic", "ilu",
    "ilut_precond", "itilu0",
    "jacobi", "multi_elimination", "multicolored_gs", "multicolored_ilu",
    "multicolored_sgs", "restricted_additive_schwarz", "saddle_point_precond",
    "sgs", "sor", "spai", "ssor", "tns", "variable_precond",
]
