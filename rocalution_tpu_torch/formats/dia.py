"""DIA storage format (reference: MatrixDIA, matrix_formats.hpp:121-130).

Counterpart of rocalution_tpu/formats/dia.py. The WJD hybrid split serves
its globally dense diagonals through this format's apply.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .base import MatrixBase, expand, get_host, set_host_cache, to_device


def dia_apply(data, offsets, shape, x):
    """DIA apply for x of shape (m,) or (m, k): pad x once; every diagonal
    is a shifted slice of it."""
    n, m = shape
    tail = tuple(x.shape[1:])
    if not offsets:
        return x.new_zeros((n,) + tail)
    lo_pad = max(0, -min(offsets))
    hi_pad = max(0, max(offsets) + n - m)
    xpad = torch.cat([x.new_zeros((lo_pad,) + tail), x,
                      x.new_zeros((hi_pad,) + tail)])
    y = None
    for d, off in enumerate(offsets):
        # rows outside [max(0,-off), min(n, m-off)) see zero: padded x is
        # zero there, and so is the diagonal's data
        seg = expand(data[d, :n], xpad[lo_pad + off: lo_pad + off + n])
        y = seg if y is None else y + seg
    return y


@dataclasses.dataclass(frozen=True)
class DIA(MatrixBase):
    data: torch.Tensor                # (ndiag, nrow); data[d, i] = A[i, i + off[d]]
    offsets: Tuple[int, ...] = ()     # diagonal offsets
    shape: Tuple[int, int] = (0, 0)

    @property
    def ndiag(self) -> int:
        return len(self.offsets)

    @property
    def nnz(self) -> int:
        """True nonzero count (explicit zeros in the band are not counted)."""
        return int(np.count_nonzero(get_host(self, "data")))

    def to_dense(self) -> torch.Tensor:
        n, m = self.shape
        out = self.data.new_zeros((n, m))
        rows = torch.arange(n, device=self.data.device)
        for d, off in enumerate(self.offsets):
            cols = rows + off
            valid = (cols >= 0) & (cols < m)
            out[rows[valid], cols[valid]] += self.data[d, :n][valid]
        return out

    @staticmethod
    def from_csr_host(csr, device=None) -> "DIA":
        data, indices, indptr = csr.numpy_triplet()
        nrow, ncol = csr.shape
        rows = np.repeat(np.arange(nrow, dtype=np.int64), np.diff(indptr))
        offs = indices - rows
        uniq, d_idx = np.unique(offs, return_inverse=True)
        dia = np.zeros((len(uniq), nrow), dtype=data.dtype)
        dia[d_idx, rows] = data
        out = DIA(
            data=to_device(dia, csr.device if device is None else device),
            offsets=tuple(int(o) for o in uniq),
            shape=(nrow, ncol),
        )
        set_host_cache(out, data=dia)
        return out
