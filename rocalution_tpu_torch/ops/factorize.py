"""Incomplete factorizations (setup phase): ILU(0) and IC(0).

Counterpart of rocalution_tpu/ops/factorize.py, copied decision for
decision (reference: LocalMatrix::ILU0Factorize / ICFactorize,
src/base/local_matrix.hpp; host kernels in host_matrix_csr.cpp).
Factorization is sequential setup work: it runs once per matrix on the
host, through the native sweep where the shared C++ layer builds (f32
values go through it in f64 and are cast back), numpy otherwise. The
factors are host-resident CSRs (``device="cpu"``, the JAX package's
``device=False``); their apply structures go to the operator's device
(ops/trisolve.py). ILU(p), ILUT and the block factorizations come with
the rest of the preconditioners (ROADMAP.md section 1 item 8).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..formats import CSR
from ..formats.base import get_host


def _host(A: CSR):
    data = get_host(A, "data").copy()
    cols = get_host(A, "indices").astype(np.int64)
    indptr = get_host(A, "indptr").astype(np.int64)
    return data, cols, indptr


def _diag_ptrs(cols, indptr, n):
    dp = np.empty(n, dtype=np.int64)
    for i in range(n):
        rs, re = indptr[i], indptr[i + 1]
        pos = np.searchsorted(cols[rs:re], i)
        if pos >= re - rs or cols[rs + pos] != i:
            raise ValueError(f"row {i} has no diagonal entry")
        dp[i] = rs + pos
    return dp


def _split_lu(data, cols, indptr, n):
    """Split a factorized in-place CSR into (L unit-lower incl diag=1,
    U upper incl diag)."""
    rows = np.repeat(np.arange(n), np.diff(indptr))
    lower = cols < rows
    upper = cols > rows
    diag = cols == rows
    ld = np.concatenate([data[lower], np.ones(n, data.dtype)])
    lr = np.concatenate([rows[lower], np.arange(n)])
    lc = np.concatenate([cols[lower], np.arange(n)])
    L = CSR.from_coo(lr, lc, ld, (n, n), device="cpu")
    ud = np.concatenate([data[upper], data[diag]])
    ur = np.concatenate([rows[upper], rows[diag]])
    uc = np.concatenate([cols[upper], cols[diag]])
    U = CSR.from_coo(ur, uc, ud, (n, n), device="cpu")
    return L, U


def _ilu0_numeric(data, cols, indptr, n):
    """In-place IKJ ILU(0) on a fixed pattern (columns sorted per row)."""
    dp = _diag_ptrs(cols, indptr, n)
    for i in range(n):
        rs, re = indptr[i], indptr[i + 1]
        ci = cols[rs:re]
        for idx in range(rs, dp[i]):
            k = cols[idx]
            dk = data[dp[k]]
            if dk == 0:
                raise ZeroDivisionError(f"zero pivot at row {k}")
            lik = data[idx] / dk
            data[idx] = lik
            krs, kre = dp[k] + 1, indptr[k + 1]
            if krs < kre:
                kcols = cols[krs:kre]
                pos = np.searchsorted(ci, kcols)
                valid = pos < (re - rs)
                safe = np.minimum(pos, re - rs - 1)
                valid &= ci[safe] == kcols
                data[rs + pos[valid]] -= lik * data[krs:kre][valid]
    return data


def _use_native(data) -> bool:
    from .. import native

    # f32 values go through the native sweep in f64 and are cast back: the
    # sweep is sequential host work where the f64 copy is noise, while the
    # numpy fallback costs seconds at 65k rows
    return data.dtype in (np.float32, np.float64) and native.available()


def ilu0(A: CSR) -> Tuple[CSR, CSR]:
    """ILU(0): incomplete LU on the sparsity pattern of A.

    Returns host-resident (L, U) with L unit-lower (explicit 1s on the
    diagonal) and U upper including the diagonal, so A ~ L @ U (reference:
    LocalMatrix::ILU0Factorize). Uses the native C++ sweep when available,
    numpy otherwise."""
    data, cols, indptr = _host(A)
    n = A.shape[0]
    if _use_native(data):
        from .. import native

        cols32 = cols.astype(np.int32)
        d64 = data.astype(np.float64, copy=False)
        native.ilu0_inplace(indptr.astype(np.int64), cols32, d64)
        data = d64.astype(data.dtype, copy=False)
    else:
        data = _ilu0_numeric(data, cols, indptr, n)
    return _split_lu(data, cols, indptr, n)


def ic0(A: CSR) -> CSR:
    """IC(0): incomplete Cholesky on the lower pattern of A.

    Returns host-resident L (lower triangular incl diagonal) with
    A ~ L @ L.T (reference: LocalMatrix::ICFactorize)."""
    data, cols, indptr = _host(A)
    n = A.shape[0]
    rows = np.repeat(np.arange(n), np.diff(indptr))
    lsel = cols <= rows
    lr, lc, lv = rows[lsel], cols[lsel], data[lsel]
    lptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(lptr, lr + 1, 1)
    lptr = np.cumsum(lptr)

    if _use_native(lv):
        from .. import native

        lv64 = lv.astype(np.float64, copy=False)
        native.ic0_inplace(lptr.astype(np.int64), lc.astype(np.int32), lv64)
        return CSR.from_coo(lr, lc, lv64.astype(lv.dtype, copy=False),
                            (n, n), device="cpu")

    for i in range(n):
        rs, re = lptr[i], lptr[i + 1]
        ci = lc[rs:re]
        for idx in range(rs, re - 1):        # off-diagonal j < i
            j = ci[idx - rs]
            js, je = lptr[j], lptr[j + 1]
            cj = lc[js:je - 1]               # row j cols < j
            # dot over common pattern cols < j
            ci_part = ci[: idx - rs]
            pos = np.searchsorted(ci_part, cj)
            valid = pos < len(ci_part)
            safe = np.minimum(pos, max(len(ci_part) - 1, 0))
            if len(ci_part):
                valid &= ci_part[safe] == cj
            else:
                valid[:] = False
            s = np.dot(lv[rs + pos[valid]], lv[js:je - 1][valid])
            djj = lv[je - 1]
            if djj == 0:
                raise ZeroDivisionError(f"zero pivot at row {j}")
            lv[idx] = (lv[idx] - s) / djj
        s = np.dot(lv[rs:re - 1], lv[rs:re - 1])
        val = lv[re - 1] - s
        if val <= 0:
            raise ValueError(f"IC(0) breakdown at row {i} (pivot {val})")
        lv[re - 1] = np.sqrt(val)
    return CSR.from_coo(lr, lc, lv, (n, n), device="cpu")
