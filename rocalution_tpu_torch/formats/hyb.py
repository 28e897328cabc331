"""HYB storage format = ELL + COO tail (reference: MatrixHYB,
matrix_formats.hpp:133-146).

Counterpart of rocalution_tpu/formats/hyb.py.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .base import MatrixBase
from .coo import COO
from .ell import ELL, ell_arrays


@dataclasses.dataclass(frozen=True)
class HYB(MatrixBase):
    ell: ELL
    coo: COO
    shape: Tuple[int, int] = (0, 0)

    @property
    def dtype(self) -> torch.dtype:
        return self.ell.data.dtype

    @property
    def device(self) -> torch.device:
        return self.ell.data.device

    @property
    def nnz(self) -> int:
        return self.ell.nnz + self.coo.nnz

    @staticmethod
    def from_csr_host(csr, width: Optional[int] = None,
                      device=None) -> "HYB":
        """Split rows at `width` (default: average row nnz, like
        rocALUTION's csr_to_hyb heuristic, host_conversion.cpp)."""
        data, indices, indptr = csr.numpy_triplet()
        nrow = csr.shape[0]
        counts = np.diff(indptr)
        if width is None:
            width = max(1, int(np.ceil(counts.mean()))) if nrow else 1
        device = csr.device if device is None else device
        ell_data, ell_ind, in_ell = ell_arrays(csr, int(width))
        rows = np.repeat(np.arange(nrow, dtype=np.int64), counts)
        tail = ~in_ell
        return HYB(
            ell=ELL.from_host_planes(ell_data, ell_ind, csr.shape, device),
            coo=COO.from_arrays(rows[tail], indices[tail], data[tail],
                                csr.shape, device=device),
            shape=tuple(csr.shape))

    def to_dense(self) -> torch.Tensor:
        return self.ell.to_dense() + self.coo.to_dense()
