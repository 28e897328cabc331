"""MCSR: modified CSR, the diagonal stored separately (reference:
MatrixMCSR, matrix_formats.hpp; used by multi-colored ILU solves).

Counterpart of rocalution_tpu/formats/mcsr.py.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .base import MatrixBase, set_host_cache, to_device
from .csr import CSR


@dataclasses.dataclass(frozen=True)
class MCSR(MatrixBase):
    diag: torch.Tensor   # (nrow,) diagonal values
    offd: CSR            # off-diagonal part as CSR
    shape: Tuple[int, int] = (0, 0)

    @property
    def dtype(self) -> torch.dtype:
        return self.diag.dtype

    @property
    def device(self) -> torch.device:
        return self.diag.device

    @property
    def nnz(self) -> int:
        return int(self.diag.shape[0]) + self.offd.nnz

    @staticmethod
    def from_csr_host(csr, device=None) -> "MCSR":
        data, indices, indptr = csr.numpy_triplet()
        nrow, ncol = csr.shape
        rows = np.repeat(np.arange(nrow, dtype=np.int64), np.diff(indptr))
        is_diag = rows == indices
        diag = np.zeros(nrow, dtype=data.dtype)
        diag[rows[is_diag]] = data[is_diag]
        device = csr.device if device is None else device
        offd = CSR.from_coo(rows[~is_diag], indices[~is_diag],
                            data[~is_diag], (nrow, ncol), device=device)
        out = MCSR(diag=to_device(diag, device), offd=offd,
                   shape=(nrow, ncol))
        set_host_cache(out, diag=diag)
        return out

    def to_dense(self) -> torch.Tensor:
        out = self.offd.to_dense()
        n = min(self.shape)
        idx = torch.arange(n, device=out.device)
        out[idx, idx] += self.diag[:n]
        return out
