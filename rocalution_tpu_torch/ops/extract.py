"""Structural extraction ops (host-side setup).

Counterpart of rocalution_tpu/ops/extract.py (reference:
LocalMatrix::ExtractL/ExtractU, ExtractSubMatrix/ExtractSubMatrices,
ExtractRowVector/ColumnVector, Scale*/AddScalar*, Compress,
CreateFromMap; src/base/local_matrix.hpp extraction block). Every op reads
the CSR's host arrays and builds the result on the host; a matrix result
lives on A's device, as a transpose does.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..formats import CSR
from ..formats.base import get_host


def _coo(A: CSR):
    return (
        get_host(A, "row_ids").astype(np.int64),
        get_host(A, "indices").astype(np.int64),
        get_host(A, "data"),
    )


def extract_lower(A: CSR, diag: bool = True) -> CSR:
    """L part of A (reference: LocalMatrix::ExtractL, include diagonal when
    `diag`)."""
    r, c, v = _coo(A)
    sel = (c <= r) if diag else (c < r)
    return CSR.from_coo(r[sel], c[sel], v[sel], A.shape, device=A.device)


def extract_upper(A: CSR, diag: bool = True) -> CSR:
    """U part of A (reference: LocalMatrix::ExtractU)."""
    r, c, v = _coo(A)
    sel = (c >= r) if diag else (c > r)
    return CSR.from_coo(r[sel], c[sel], v[sel], A.shape, device=A.device)


def extract_submatrix(A: CSR, row_offset: int, col_offset: int,
                      nrow: int, ncol: int) -> CSR:
    """Contiguous submatrix (reference: LocalMatrix::ExtractSubMatrix)."""
    r, c, v = _coo(A)
    sel = (
        (r >= row_offset) & (r < row_offset + nrow)
        & (c >= col_offset) & (c < col_offset + ncol)
    )
    return CSR.from_coo(r[sel] - row_offset, c[sel] - col_offset, v[sel],
                        (nrow, ncol), device=A.device)


def extract_index_submatrix(A: CSR, rows: np.ndarray,
                            cols: np.ndarray) -> CSR:
    """Submatrix by index sets (for overlapping Schwarz blocks)."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    rmap = np.full(A.shape[0], -1, np.int64)
    rmap[rows] = np.arange(len(rows))
    cmap = np.full(A.shape[1], -1, np.int64)
    cmap[cols] = np.arange(len(cols))
    r, c, v = _coo(A)
    sel = (rmap[r] >= 0) & (cmap[c] >= 0)
    return CSR.from_coo(rmap[r[sel]], cmap[c[sel]], v[sel],
                        (len(rows), len(cols)), device=A.device)


def block_sizes(n: int, num_blocks: int) -> List[int]:
    """Sizes of `num_blocks` contiguous blocks of n rows, the first n %
    num_blocks one row longer (reference: ExtractSubMatrices' split)."""
    return [n // num_blocks + (1 if i < n % num_blocks else 0)
            for i in range(num_blocks)]


def extract_submatrices(A: CSR, num_blocks: int) -> List[List[CSR]]:
    """num_blocks x num_blocks grid of contiguous blocks (reference:
    LocalMatrix::ExtractSubMatrices — BlockPreconditioner setup)."""
    sizes = block_sizes(A.shape[0], num_blocks)
    offs = np.concatenate([[0], np.cumsum(sizes)])
    return [[extract_submatrix(A, offs[i], offs[j], sizes[i], sizes[j])
             for j in range(num_blocks)]
            for i in range(num_blocks)]


def _with(A: CSR, r, c, v) -> CSR:
    return CSR.from_coo(r, c, v, A.shape, device=A.device)


def scale_diagonal(A: CSR, alpha: float) -> CSR:
    """A with diagonal scaled (reference: LocalMatrix::ScaleDiagonal)."""
    r, c, v = _coo(A)
    v = v.copy()
    v[r == c] *= alpha
    return _with(A, r, c, v)


def scale(A: CSR, alpha: float) -> CSR:
    """alpha * A (reference: LocalMatrix::Scale)."""
    r, c, v = _coo(A)
    return _with(A, r, c, v * alpha)


def scale_off_diagonal(A: CSR, alpha: float) -> CSR:
    """Off-diagonal entries scaled (LocalMatrix::ScaleOffDiagonal)."""
    r, c, v = _coo(A)
    v = v.copy()
    v[r != c] *= alpha
    return _with(A, r, c, v)


def add_scalar(A: CSR, alpha: float) -> CSR:
    """alpha added to every STORED entry (LocalMatrix::AddScalar — the
    reference mutates the nonzero pattern's values, not the dense form)."""
    r, c, v = _coo(A)
    return _with(A, r, c, v + alpha)


def add_scalar_diagonal(A: CSR, alpha: float) -> CSR:
    """alpha added to stored diagonal entries
    (LocalMatrix::AddScalarDiagonal)."""
    r, c, v = _coo(A)
    v = v.copy()
    v[r == c] += alpha
    return _with(A, r, c, v)


def add_scalar_off_diagonal(A: CSR, alpha: float) -> CSR:
    """alpha added to stored off-diagonal entries
    (LocalMatrix::AddScalarOffDiagonal)."""
    r, c, v = _coo(A)
    v = v.copy()
    v[r != c] += alpha
    return _with(A, r, c, v)


def compress(A: CSR, drop_off: float) -> CSR:
    """Drop entries with |a_ij| <= drop_off, keeping the diagonal
    (reference: LocalMatrix::Compress — the diagonal is always
    retained)."""
    r, c, v = _coo(A)
    sel = (np.abs(v) > drop_off) | (r == c)
    return _with(A, r[sel], c[sel], v[sel])


def extract_column_vector(A: CSR, idx: int) -> np.ndarray:
    """Dense column idx of A (LocalMatrix::ExtractColumnVector)."""
    r, c, v = _coo(A)
    out = np.zeros(A.shape[0], dtype=v.dtype)
    sel = c == idx
    out[r[sel]] = v[sel]
    return out


def extract_row_vector(A: CSR, idx: int) -> np.ndarray:
    """Dense row idx of A (LocalMatrix::ExtractRowVector)."""
    r, c, v = _coo(A)
    out = np.zeros(A.shape[1], dtype=v.dtype)
    sel = r == idx
    out[c[sel]] = v[sel]
    return out


def replace_column_vector(A: CSR, idx: int, vec) -> CSR:
    """Replace column idx with the dense vector's nonzero structure
    (LocalMatrix::ReplaceColumnVector — structural replacement)."""
    r, c, v = _coo(A)
    keep = c != idx
    vec = np.asarray(vec)
    nz = np.flatnonzero(vec)
    return _with(A, np.concatenate([r[keep], nz]),
                 np.concatenate([c[keep], np.full(len(nz), idx, np.int64)]),
                 np.concatenate([v[keep], vec[nz].astype(v.dtype)]))


def replace_row_vector(A: CSR, idx: int, vec) -> CSR:
    """Replace row idx with the dense vector's nonzero structure
    (LocalMatrix::ReplaceRowVector)."""
    r, c, v = _coo(A)
    keep = r != idx
    vec = np.asarray(vec)
    nz = np.flatnonzero(vec)
    return _with(A,
                 np.concatenate([r[keep], np.full(len(nz), idx, np.int64)]),
                 np.concatenate([c[keep], nz]),
                 np.concatenate([v[keep], vec[nz].astype(v.dtype)]))


def create_from_map(fmap, n: int, m: int, dtype=np.float64):
    """Build the (m x n) restriction operator R with R[fmap[i], i] = 1 for
    fmap[i] >= 0, and its (n x m) prolongation transpose
    (LocalMatrix::CreateFromMap, host_matrix_csr.cpp:4127-4255), on the
    default device."""
    fmap = np.asarray(fmap, np.int64)
    i = np.flatnonzero(fmap >= 0)
    ones = np.ones(len(i), dtype)
    R = CSR.from_coo(fmap[i], i, ones, (m, n))
    P = CSR.from_coo(i, fmap[i], ones, (n, m))
    return R, P
