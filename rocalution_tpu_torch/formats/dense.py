"""DENSE format (reference: MatrixDENSE, matrix_formats.hpp:149-156).

Counterpart of rocalution_tpu/formats/dense.py; its apply is a plain
matrix product.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..config import resolve_device
from .base import MatrixBase, set_host_cache, to_device


@dataclasses.dataclass(frozen=True)
class DENSE(MatrixBase):
    data: torch.Tensor  # (nrow, ncol)
    shape: Tuple[int, int] = (0, 0)

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0] * self.data.shape[1])

    @staticmethod
    def from_array(a, device=None) -> "DENSE":
        a = np.asarray(a)
        out = DENSE(data=to_device(a, resolve_device(device)),
                    shape=(int(a.shape[0]), int(a.shape[1])))
        set_host_cache(out, data=a)
        return out

    @staticmethod
    def from_csr_host(csr, device=None) -> "DENSE":
        data, indices, _ = csr.numpy_triplet()
        dense = np.zeros(csr.shape, dtype=data.dtype)
        np.add.at(dense, (csr.numpy_rows(), indices), data)
        return DENSE.from_array(
            dense, device=csr.device if device is None else device)

    def to_dense(self) -> torch.Tensor:
        return self.data
