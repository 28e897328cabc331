"""Sparse matrix–matrix operations (setup phase).

Counterpart of rocalution_tpu/ops/spgemm.py (reference:
LocalMatrix::MatMatMult, MatrixAdd, TripleMatrixProduct, Transpose,
src/base/local_matrix.hpp). The symbolic and numeric passes run on the
host: the native two-thread Gustavson kernel where it is built (f64), scipy
otherwise. The numeric-only refresh of a frozen pattern (`spgemm_plan`,
`triple_product_plan`) runs on the device of the values it is given: one
gather-multiply and one `index_add_` over a precomputed triple list, the
analog of ReBuildNumeric.
"""

from __future__ import annotations

import numpy as np
import torch

from ..formats import CSR
from ..formats.base import get_host, to_device


def _scipy(A: CSR):
    import scipy.sparse as sp

    return sp.csr_matrix(
        (get_host(A, "data"), get_host(A, "indices").astype(np.int64),
         get_host(A, "indptr").astype(np.int64)), shape=A.shape,
    )


def from_scipy(S, device=None) -> CSR:
    """The CSR of a scipy matrix: its arrays as they are, once in
    canonical form (sorted, no duplicates), which is what the JAX
    package's COO round trip gives, without the sort of all entries."""
    S = S.tocsr()
    S.sum_duplicates()
    return CSR.from_arrays(S.data, S.indices, S.indptr, S.shape,
                           device=device)


def spmm_host(Sa, Sb):
    """scipy-CSR @ scipy-CSR through the native Gustavson kernel when it is
    available and both operands are f64 (sorted rows; the reference's
    csrgemm analog); scipy otherwise."""
    import scipy.sparse as sp

    from .. import native

    if (native.available() and Sa.dtype == np.float64
            and Sb.dtype == np.float64):
        Sa, Sb = Sa.tocsr(), Sb.tocsr()
        ptr, col, val = native.spgemm(Sa.indptr, Sa.indices, Sa.data,
                                      Sb.indptr, Sb.indices, Sb.data,
                                      Sb.shape[1])
        return sp.csr_matrix((val, col, ptr),
                             shape=(Sa.shape[0], Sb.shape[1]))
    return (Sa @ Sb).tocsr()


def spgemm(A: CSR, B: CSR) -> CSR:
    """C = A @ B on A's device (reference: LocalMatrix::MatMatMult)."""
    return from_scipy(spmm_host(_scipy(A), _scipy(B)), A.device)


def spgeam(A: CSR, B: CSR, alpha=1.0, beta=1.0) -> CSR:
    """C = alpha A + beta B on A's device (reference: LocalMatrix::
    MatrixAdd)."""
    return from_scipy((alpha * _scipy(A) + beta * _scipy(B)).tocsr(),
                      A.device)


def transpose(A: CSR) -> CSR:
    """A^T (reference: LocalMatrix::Transpose)."""
    return A.transpose_host()


def triple_product(R: CSR, A: CSR, P: CSR) -> CSR:
    """Galerkin product R A P on A's device (reference: LocalMatrix::
    TripleMatrixProduct — the AMG coarse-operator construction)."""
    return from_scipy(spmm_host(spmm_host(_scipy(R), _scipy(A)), _scipy(P)),
                      A.device)


class _OnDevice:
    """Host index arrays, uploaded once to each device that asks."""

    def __init__(self, *arrays):
        self._host, self._dev = arrays, {}

    def on(self, device):
        if device not in self._dev:
            self._dev[device] = tuple(to_device(a, device)
                                      for a in self._host)
        return self._dev[device]


def spgemm_plan(A: CSR, B: CSR):
    """Symbolic pass returning (pattern CSR of C on A's device, numeric
    update fn).

    The update fn recomputes C.data from new A.data / B.data on the FROZEN
    pattern, on the device of a_data (one multiply + `index_add_`): the
    analog of ReBuildNumeric without re-running symbolic SpGEMM.
    """
    Sa, Sb = _scipy(A), _scipy(B)
    pat = (abs(Sa) @ abs(Sb)).tocsr()
    pat.sort_indices()   # scipy SpGEMM leaves indices unsorted
    C = from_scipy(pat, A.device)
    # triple list: every scalar product a_ik * b_kj contributing to c_ij
    a_coo = Sa.tocoo()
    ai, ak, apos = a_coo.row, a_coo.col, np.arange(Sa.nnz)
    # expand: for each A nonzero (i,k), all B nonzeros in row k
    bptr = Sb.indptr.astype(np.int64)
    counts = np.diff(bptr)[ak]
    total = int(counts.sum())
    rep_ai = np.repeat(ai, counts)
    rep_apos = np.repeat(apos, counts)
    # ragged expand of [bptr[k], bptr[k]+counts) without a Python loop
    cum = np.concatenate([[0], np.cumsum(counts)])[:-1]
    boffsets = (np.repeat(bptr[ak], counts)
                + np.arange(total) - np.repeat(cum, counts))
    bj = Sb.indices[boffsets].astype(np.int64)
    # map (i, j) -> position in C pattern: CSR ordering makes the combined
    # key row*ncol+col globally sorted, so one searchsorted suffices
    ncol = pat.shape[1]
    crow = np.repeat(np.arange(pat.shape[0], dtype=np.int64),
                     np.diff(pat.indptr))
    ckeys = crow * ncol + pat.indices.astype(np.int64)
    cpos = np.searchsorted(ckeys, rep_ai.astype(np.int64) * ncol + bj)
    index = _OnDevice(rep_apos.astype(np.int64), boffsets.astype(np.int64),
                      cpos.astype(np.int64))
    nnz_c = pat.nnz

    def numeric(a_data, b_data):
        ra, bo, cp = index.on(a_data.device)
        prod = a_data[ra] * b_data[bo]
        return prod.new_zeros(nnz_c).index_add_(0, cp, prod)

    return C, numeric


def triple_product_plan(R: CSR, A: CSR, P: CSR):
    """Symbolic-once / numeric-on-device Galerkin: returns (pattern CSR of
    R·A·P, update fn).

    The symbolic pass (two host SpGEMM patterns, R and P frozen) runs once;
    `update(a_data)` then recomputes the coarse values on a_data's device —
    the analog of the reference's ReBuildNumeric path reusing the csrgemm
    info structure (local_matrix.cpp; hip_matrix_csr.cpp)."""
    B, num_ap = spgemm_plan(A, P)
    C, num_rb = spgemm_plan(R, B)
    frozen = {}

    def update(a_data):
        dev = a_data.device
        if dev not in frozen:
            frozen[dev] = (R.data.to(dev), P.data.to(dev))
        r_data, p_data = frozen[dev]
        b_data = num_ap(a_data, p_data)
        return num_rb(r_data, b_data)

    return C, update
