"""Matrix storage formats (reference: src/base/matrix_formats.hpp:38-48,
enum DENSE/CSR/MCSR/BCSR/COO/DIA/ELL/HYB) plus WJD."""

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
from .wjd import WJD

__all__ = [
    "MatrixBase", "CSR", "COO", "ELL", "DIA", "HYB", "BCSR", "MCSR", "DENSE",
    "WJD", "FORMATS", "cast_values", "convert", "to_csr",
]
