"""CSR storage format.

Counterpart of rocalution_tpu/formats/csr.py (reference: `MatrixCSR`,
src/base/matrix_formats.hpp:51-66). Like the JAX package it carries
`row_ids` (the row of every nonzero), so the plain SpMV is a gather plus
`index_add_` with no per-call recomputation.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..config import resolve_device
from .base import MatrixBase, get_host, set_host_cache, to_device


@dataclasses.dataclass(frozen=True)
class CSR(MatrixBase):
    data: torch.Tensor       # (nnz,) values
    indices: torch.Tensor    # (nnz,) column indices, int32
    indptr: torch.Tensor     # (nrow+1,) row pointers, int32
    row_ids: torch.Tensor    # (nnz,) row index of each nonzero, int32
    shape: Tuple[int, int] = (0, 0)

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @staticmethod
    def from_arrays(data, indices, indptr, shape, device=None) -> "CSR":
        """Build from a host CSR triplet; computes row_ids once on the host
        and keeps numpy copies of every array (see base.set_host_cache).
        ``device="cpu"`` makes a host-resident matrix: the counterpart of
        the JAX package's ``device=False`` for setup intermediates (AMG
        levels before a cycle closure places them on the card)."""
        device = resolve_device(device)
        nrow = int(shape[0])
        data = np.asarray(data)
        ip = np.asarray(indptr, dtype=np.int64)
        row_ids_np = np.repeat(np.arange(nrow, dtype=np.int32), np.diff(ip))
        out = CSR(
            data=to_device(data, device),
            indices=to_device(indices, device, np.int32),
            indptr=to_device(ip, device, np.int32),
            row_ids=to_device(row_ids_np, device),
            shape=(int(shape[0]), int(shape[1])),
        )
        # arrays in their NATIVE dtypes (no astype copies): consumers
        # astype on access (numpy_triplet, numpy_rows)
        set_host_cache(out, data=data, indices=np.asarray(indices),
                       indptr=ip, row_ids=row_ids_np)
        return out

    @staticmethod
    def from_coo(rows, cols, vals, shape, sum_duplicates: bool = True,
                 device=None) -> "CSR":
        """Host-side build from COO triplets (sorts by (row, col))."""
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals)
        nrow, ncol = int(shape[0]), int(shape[1])
        # one stable sort of the (row, col) key, on torch's threads:
        # lexsort's order, in a fraction of its time (int32 indices keep
        # nrow * ncol below 2**62, so the key cannot overflow)
        order = torch.sort(torch.from_numpy(rows * ncol + cols),
                           stable=True).indices.numpy()
        rows, cols, vals = rows[order], cols[order], vals[order]
        if sum_duplicates and len(rows) > 0:
            same = (rows[1:] == rows[:-1]) & (cols[1:] == cols[:-1])
            if same.any():
                # accumulate duplicate entries in order onto the first of
                # each run; + 0 makes a lone -0.0 the +0.0 that summing
                # from zero gives
                group = np.concatenate([[0], np.cumsum(~same)])
                first = np.concatenate([[True], ~same])
                out_vals = vals[first] + vals.dtype.type(0)
                np.add.at(out_vals, group[~first], vals[~first])
                rows, cols, vals = rows[first], cols[first], out_vals
        indptr = np.zeros(nrow + 1, dtype=np.int64)
        indptr[1:] = np.cumsum(np.bincount(rows, minlength=nrow))
        return CSR.from_arrays(vals, cols, indptr, shape, device=device)

    @staticmethod
    def from_dense(dense, device=None) -> "CSR":
        d = np.asarray(dense)
        rows, cols = np.nonzero(d)
        return CSR.from_coo(rows, cols, d[rows, cols], d.shape, device=device)

    def to_dense(self) -> torch.Tensor:
        out = self.data.new_zeros(self.shape)
        return out.index_put_((self.row_ids.long(), self.indices.long()),
                              self.data, accumulate=True)

    def transpose_host(self) -> "CSR":
        """Host-side transpose (setup phase; analog LocalMatrix::Transpose),
        on this matrix's device."""
        rows = get_host(self, "row_ids")
        cols = get_host(self, "indices")
        vals = get_host(self, "data")
        return CSR.from_coo(cols, rows, vals, (self.shape[1], self.shape[0]),
                            device=self.device)

    def numpy_triplet(self):
        """Host CSR triplet from the host cache (no device read)."""
        return (
            get_host(self, "data"),
            get_host(self, "indices").astype(np.int64),
            get_host(self, "indptr").astype(np.int64),
        )

    def numpy_rows(self):
        return get_host(self, "row_ids").astype(np.int64)
