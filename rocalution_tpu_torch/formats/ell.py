"""ELL storage format (reference: MatrixELL, matrix_formats.hpp:107-118).

Counterpart of rocalution_tpu/formats/ell.py: a fixed row width makes SpMV
one gather of x, a dense (nrow, width) multiply and a row reduction.
Padding entries store column = -1 and value = 0.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .base import MatrixBase, get_host, set_host_cache, to_device


def ell_arrays(csr, width: int):
    """Host (nrow, width) ELL planes of a CSR plus the mask of the entries
    they hold (position within the row < width)."""
    data, indices, indptr = csr.numpy_triplet()
    nrow = csr.shape[0]
    counts = np.diff(indptr)
    ell_data = np.zeros((nrow, width), dtype=data.dtype)
    ell_ind = np.full((nrow, width), -1, dtype=np.int32)
    # vectorized fill: position of each nnz within its row
    pos = np.arange(len(data)) - np.repeat(indptr[:-1], counts)
    rows = np.repeat(np.arange(nrow, dtype=np.int64), counts)
    keep = pos < width
    ell_data[rows[keep], pos[keep]] = data[keep]
    ell_ind[rows[keep], pos[keep]] = indices[keep]
    return ell_data, ell_ind, keep


@dataclasses.dataclass(frozen=True)
class ELL(MatrixBase):
    data: torch.Tensor     # (nrow, width)
    indices: torch.Tensor  # (nrow, width) int32, -1 = padding
    shape: Tuple[int, int] = (0, 0)

    @property
    def width(self) -> int:
        return int(self.data.shape[1])

    @property
    def nnz(self) -> int:
        """True nnz by the padding mask (the reference counts nrow*width)."""
        return int(np.count_nonzero(get_host(self, "indices") >= 0))

    @property
    def nnz_padded(self) -> int:
        return int(self.data.shape[0] * self.data.shape[1])

    @staticmethod
    def from_host_planes(ell_data, ell_ind, shape, device) -> "ELL":
        out = ELL(data=to_device(ell_data, device),
                  indices=to_device(ell_ind, device), shape=tuple(shape))
        set_host_cache(out, data=ell_data, indices=ell_ind)
        return out

    @staticmethod
    def from_csr_host(csr, width: Optional[int] = None,
                      device=None) -> "ELL":
        counts = np.diff(csr.numpy_triplet()[2])
        w = int(width) if width is not None else (
            int(counts.max()) if csr.shape[0] else 0)
        ell_data, ell_ind, _ = ell_arrays(csr, max(w, 1))
        return ELL.from_host_planes(
            ell_data, ell_ind, csr.shape,
            csr.device if device is None else device)

    def to_dense(self) -> torch.Tensor:
        out = self.data.new_zeros(self.shape)
        rows = torch.arange(self.shape[0], device=self.data.device)[:, None]
        mask = self.indices >= 0
        rows = rows.expand_as(self.indices)[mask]
        return out.index_put_((rows, self.indices[mask].long()),
                              self.data[mask], accumulate=True)
