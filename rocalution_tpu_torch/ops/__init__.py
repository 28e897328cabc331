"""Vector and sparse-matrix operations."""

from . import blas1
from .spmv import attach_wjd, spmv, spmv_add

__all__ = ["blas1", "attach_wjd", "spmv", "spmv_add"]
