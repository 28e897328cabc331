"""BCSR storage format (reference: MatrixBCSR, matrix_formats.hpp:83-104).

Counterpart of rocalution_tpu/formats/bcsr.py: dense square blocks; SpMV
batches all block-times-vector products into one batched product.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .base import MatrixBase, get_host, set_host_cache, to_device


@dataclasses.dataclass(frozen=True)
class BCSR(MatrixBase):
    data: torch.Tensor      # (nnzb, bd, bd) dense blocks
    indices: torch.Tensor   # (nnzb,) block-column indices, int32
    indptr: torch.Tensor    # (nrowb+1,) int32
    row_ids: torch.Tensor   # (nnzb,) block-row id of each block, int32
    block_dim: int = 1
    shape: Tuple[int, int] = (0, 0)   # scalar shape

    @property
    def nrowb(self) -> int:
        return int(self.indptr.shape[0]) - 1

    @property
    def nnzb(self) -> int:
        return int(self.data.shape[0])

    @property
    def nnz(self) -> int:
        return int(np.count_nonzero(get_host(self, "data")))

    @staticmethod
    def from_csr_host(csr, block_dim: int, device=None) -> "BCSR":
        data, indices, indptr = csr.numpy_triplet()
        nrow, ncol = csr.shape
        bd = int(block_dim)
        nrowb = -(-nrow // bd)
        ncolb = -(-ncol // bd)
        rows = np.repeat(np.arange(nrow, dtype=np.int64), np.diff(indptr))
        # unique (block row, block column) pairs define the block pattern
        key = (rows // bd) * ncolb + indices // bd
        uniq_key = np.unique(key)
        block_of_nnz = np.searchsorted(uniq_key, key)
        blocks = np.zeros((len(uniq_key), bd, bd), dtype=data.dtype)
        np.add.at(blocks, (block_of_nnz, rows % bd, indices % bd), data)
        ub_rows = (uniq_key // ncolb).astype(np.int64)
        ub_cols = (uniq_key % ncolb).astype(np.int32)
        bindptr = np.zeros(nrowb + 1, dtype=np.int64)
        np.add.at(bindptr, ub_rows + 1, 1)
        bindptr = np.cumsum(bindptr)
        device = csr.device if device is None else device
        out = BCSR(
            data=to_device(blocks, device),
            indices=to_device(ub_cols, device),
            indptr=to_device(bindptr, device, np.int32),
            row_ids=to_device(ub_rows, device, np.int32),
            block_dim=bd,
            shape=(nrow, ncol),
        )
        set_host_cache(out, data=blocks, indices=ub_cols, row_ids=ub_rows)
        return out

    def to_dense(self) -> torch.Tensor:
        bd = self.block_dim
        nrowb = self.nrowb
        ncolb = -(-self.shape[1] // bd)
        big = self.data.new_zeros((nrowb, ncolb, bd, bd))
        big.index_put_((self.row_ids.long(), self.indices.long()), self.data,
                       accumulate=True)
        dense = big.permute(0, 2, 1, 3).reshape(nrowb * bd, ncolb * bd)
        return dense[: self.shape[0], : self.shape[1]]
