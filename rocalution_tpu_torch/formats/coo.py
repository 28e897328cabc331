"""COO storage format (reference: MatrixCOO, matrix_formats.hpp:69-80).

Counterpart of rocalution_tpu/formats/coo.py.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..config import resolve_device
from .base import MatrixBase, set_host_cache, to_device


@dataclasses.dataclass(frozen=True)
class COO(MatrixBase):
    data: torch.Tensor  # (nnz,)
    row: torch.Tensor   # (nnz,) int32
    col: torch.Tensor   # (nnz,) int32
    shape: Tuple[int, int] = (0, 0)

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @staticmethod
    def from_arrays(row, col, data, shape, device=None) -> "COO":
        device = resolve_device(device)
        data = np.asarray(data)
        out = COO(
            data=to_device(data, device),
            row=to_device(row, device, np.int32),
            col=to_device(col, device, np.int32),
            shape=(int(shape[0]), int(shape[1])),
        )
        set_host_cache(out, data=data, row=np.asarray(row, dtype=np.int64),
                       col=np.asarray(col, dtype=np.int64))
        return out

    @staticmethod
    def from_dense(dense, device=None) -> "COO":
        d = np.asarray(dense)
        r, c = np.nonzero(d)
        return COO.from_arrays(r, c, d[r, c], d.shape, device=device)

    def to_dense(self) -> torch.Tensor:
        out = self.data.new_zeros(self.shape)
        return out.index_put_((self.row.long(), self.col.long()), self.data,
                              accumulate=True)
