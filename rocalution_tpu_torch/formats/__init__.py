"""Matrix storage formats (reference: src/base/matrix_formats.hpp:38-48,
enum DENSE/CSR/MCSR/BCSR/COO/DIA/ELL/HYB) plus WJD, ComplexWJD and the
matrix-free Stencil."""

from .base import MatrixBase
from .bcsr import BCSR
from .convert import FORMATS, cast_values, convert, to_csr
from .coo import COO
from .csr import CSR
from .dense import DENSE
from .dia import DIA
from .ell import ELL
from .hyb import HYB
from .mcsr import MCSR
from .stencil import Stencil, laplace2d_stencil, laplace3d_stencil
from .wjd import WJD, ComplexWJD

__all__ = [
    "MatrixBase", "CSR", "COO", "ELL", "DIA", "HYB", "BCSR", "MCSR", "DENSE",
    "Stencil", "WJD", "ComplexWJD", "FORMATS", "cast_values", "convert",
    "laplace2d_stencil", "laplace3d_stencil", "to_csr",
]
