"""Incomplete factorizations (setup phase): ILU(0), IC(0), ILU(p), ILUT
and the block factorizations BSR-ILU(0) and BSR-IC(0).

Counterpart of rocalution_tpu/ops/factorize.py, copied decision for
decision (reference: LocalMatrix::ILU0Factorize / ICFactorize /
ILUpFactorize / ILUTFactorize, src/base/local_matrix.hpp; host kernels in
host_matrix_csr.cpp and host_ilut_driver_csr.cpp; rocsparse bsrilu0 and
bsric0). Factorization is sequential setup work: it runs once per matrix
on the host, through the native sweep where the shared C++ layer builds
(f32 values go through it in f64 and are cast back, for ILU(p) and ILUT
too: the JAX package hands those f32 buffers to the f64 entry points,
ROADMAP.md section 3 fault 9), numpy otherwise. The factors are
host-resident CSRs (``device="cpu"``, the JAX package's ``device=False``);
their apply structures go to the operator's device (ops/trisolve.py).
"""

from __future__ import annotations

import bisect
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


def _symbolic_ilup(cols, indptr, n, p):
    """Level-of-fill symbolic phase of ILU(p). Returns the expanded pattern
    (rows, cols) with the fill-in of level <= p, sorted by (row, col)."""
    if p == 1:
        return _symbolic_ilu1(cols, indptr, n)
    out_rows, out_cols = [], []
    upper = [None] * n  # per-row list of (col > i, level)
    for i in range(n):
        lev = {}
        for c in cols[indptr[i]:indptr[i + 1]]:
            lev[int(c)] = 0
        ks = sorted(c for c in lev if c < i)
        seen = set(ks)
        while ks:
            k = ks.pop(0)
            lev_ik = lev[k]
            if lev_ik > p:
                continue
            for j, lev_kj in upper[k]:
                f = lev_ik + lev_kj + 1
                if f <= p and (j not in lev or lev[j] > f):
                    lev[j] = min(lev.get(j, f), f)
                    if j < i and j not in seen:
                        seen.add(j)
                        bisect.insort(ks, j)     # ks stays ascending
        cs = sorted(lev)
        out_rows.extend([i] * len(cs))
        out_cols.extend(cs)
        upper[i] = [(j, lev[j]) for j in cs if j > i]
    return np.asarray(out_rows, np.int64), np.asarray(out_cols, np.int64)


def _symbolic_ilu1(cols, indptr, n):
    """The level-1 pattern in sparse products: a fill entry (i, j) has
    level lev(i, k) + lev(k, j) + 1 for some k < i with k < j, which is 1
    only where both are entries of A (level 0), so the pattern is A's
    joined with that of strict_lower(A) @ strict_upper(A), the same set
    the row sweep of the general case gives for p = 1."""
    import scipy.sparse as sp

    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    pat = sp.csr_matrix((np.ones(len(cols), np.int32), (rows, cols)),
                        shape=(n, n))
    low, up = sp.tril(pat, -1).tocsr(), sp.triu(pat, 1).tocsr()
    fill = (pat + (low @ up)).tocoo()
    order = np.lexsort((fill.col, fill.row))
    return (fill.row[order].astype(np.int64),
            fill.col[order].astype(np.int64))


def ilup(A: CSR, p: int = 1) -> Tuple[CSR, CSR]:
    """ILU(p): level-of-fill incomplete LU (reference:
    LocalMatrix::ILUpFactorize). Returns (L, U) like ilu0."""
    if p == 0:
        return ilu0(A)
    data, cols, indptr = _host(A)
    n = A.shape[0]
    frows, fcols = _symbolic_ilup(cols, indptr, n, p)
    fptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(fptr, frows + 1, 1)
    fptr = np.cumsum(fptr)
    # A's values onto the expanded pattern: both are sorted by (row, col),
    # so one search over the pattern's keys places every entry
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    fdata = np.zeros(len(frows), dtype=data.dtype)
    fdata[np.searchsorted(frows * n + fcols, rows * n + cols)] = data
    if _use_native(fdata):
        from .. import native

        d64 = fdata.astype(np.float64, copy=False)
        native.ilu0_inplace(fptr, fcols.astype(np.int32), d64)
        fdata = d64.astype(data.dtype, copy=False)
    else:
        fdata = _ilu0_numeric(fdata, fcols, fptr, n)
    return _split_lu(fdata, fcols, fptr, n)


def ilut(A: CSR, tol: float = 1e-3, max_fill: int = 32) -> Tuple[CSR, CSR]:
    """ILUT(t, m): threshold + max-fill incomplete LU (reference:
    LocalMatrix::ILUTFactorize, host_ilut_driver_csr.cpp). Returns (L, U)
    like ilu0."""
    data, cols, indptr = _host(A)
    n = A.shape[0]
    if _use_native(data):
        from .. import native

        lr, lc, lv, ur, uc, uv = native.ilut(
            indptr, cols.astype(np.int32),
            data.astype(np.float64, copy=False), tol, max_fill)
        lr = np.concatenate([lr, np.arange(n)])
        lc = np.concatenate([lc, np.arange(n)])
        lv = np.concatenate([lv.astype(data.dtype), np.ones(n, data.dtype)])
        L = CSR.from_coo(lr, lc, lv, (n, n), device="cpu")
        U = CSR.from_coo(ur, uc, uv.astype(data.dtype), (n, n), device="cpu")
        return L, U
    U_rows = [None] * n   # (cols >= k ascending, vals); diagonal first
    L_out_r, L_out_c, L_out_v = [], [], []
    for i in range(n):
        rs, re = indptr[i], indptr[i + 1]
        w = dict(zip(cols[rs:re].tolist(), data[rs:re].tolist()))
        row_norm = float(np.linalg.norm(data[rs:re])) or 1.0
        drop = tol * row_norm
        ks = sorted(c for c in w if c < i)
        seen = set(ks)
        while ks:
            k = ks.pop(0)
            ucols, uvals = U_rows[k]
            lik = w[k] / uvals[0]          # U's diagonal comes first
            if abs(lik) < drop:
                del w[k]
                continue
            w[k] = lik
            for c, v in zip(ucols[1:], uvals[1:]):
                w[c] = w.get(c, 0.0) - lik * v
                if c < i and c not in seen:
                    seen.add(c)
                    bisect.insort(ks, c)
        if i not in w:
            raise ZeroDivisionError(f"ILUT lost the diagonal at row {i}")
        lw = [(c, v) for c, v in w.items() if c < i and abs(v) >= drop]
        uw = [(c, v) for c, v in w.items() if c > i and abs(v) >= drop]
        lw.sort(key=lambda cv: -abs(cv[1]))
        uw.sort(key=lambda cv: -abs(cv[1]))
        lw = sorted(lw[:max_fill])
        uw = sorted(uw[:max_fill])
        dval = w[i]
        if dval == 0:
            raise ZeroDivisionError(f"ILUT zero pivot at row {i}")
        for c, v in lw:
            L_out_r.append(i)
            L_out_c.append(c)
            L_out_v.append(v)
        U_rows[i] = (np.asarray([i] + [c for c, _ in uw], np.int64),
                     np.asarray([dval] + [v for _, v in uw], data.dtype))
    L_out_r.extend(range(n))
    L_out_c.extend(range(n))
    L_out_v.extend([1.0] * n)
    L = CSR.from_coo(L_out_r, L_out_c, np.asarray(L_out_v, data.dtype),
                     (n, n), device="cpu")
    ur = np.concatenate([np.full(len(U_rows[i][0]), i) for i in range(n)])
    uc = np.concatenate([U_rows[i][0] for i in range(n)])
    uv = np.concatenate([U_rows[i][1] for i in range(n)])
    return L, CSR.from_coo(ur, uc, uv, (n, n), device="cpu")


# BCSR factorizations (reference: rocsparse bsrilu0/bsric0 behind
# HIPAcceleratorMatrixBCSR::{ILU0,IC0}Factorize, hip_matrix_bcsr.cpp:
# 747-786): dense (bd, bd) blocks over the BLOCK sparsity pattern. The JAX
# package sweeps the block rows one by one in Python; the port computes
# the same values a level of block rows at a time (a row after every row
# it reads), one batched numpy operation a step, which takes a million
# rows in seconds. The applies ride the scalar level schedules on
# flattened factors (precond/ilu.py bsr_ilu0, bsr_ic0).

def _bcsr_host(A):
    """(blocks, bcols, brows, bindptr, nrowb, bd) from host caches only;
    blocks sorted by (row, col)."""
    from ..formats.bcsr import BCSR

    assert isinstance(A, BCSR)
    blocks = get_host(A, "data").copy()
    bcols = get_host(A, "indices").astype(np.int64)
    brows = get_host(A, "row_ids").astype(np.int64)
    nrowb = -(-A.shape[0] // A.block_dim)
    bindptr = np.concatenate(
        ([0], np.cumsum(np.bincount(brows, minlength=nrowb))))
    return blocks, bcols, brows, bindptr, nrowb, A.block_dim


def _lookup(keys, want):
    """Index of each wanted key in the sorted keys, -1 where absent."""
    if len(keys) == 0:
        return np.full(len(want), -1, np.int64)
    pos = np.minimum(np.searchsorted(keys, want), len(keys) - 1)
    return np.where(keys[pos] == want, pos, -1)


def _row_entries(bindptr, rows):
    """(owner, block) for every block of the given rows: owner indexes
    `rows`."""
    deg = bindptr[rows + 1] - bindptr[rows]
    owner = np.repeat(np.arange(len(rows)), deg)
    first = np.repeat(bindptr[rows] - np.cumsum(deg) + deg, deg)
    return owner, first + np.arange(int(deg.sum()))


def _row_levels(bcols, brows, nrowb):
    """Kahn level of each block row over its strictly lower blocks: a row
    comes one level after the deepest row j < i it has a block in."""
    import scipy.sparse as sp

    dep = bcols < brows
    ndeps = np.bincount(brows[dep], minlength=nrowb)
    radj = sp.csr_matrix((np.ones(int(dep.sum()), np.int8),
                          (bcols[dep], brows[dep])), shape=(nrowb, nrowb))
    level = np.zeros(nrowb, np.int64)
    frontier, lev = np.flatnonzero(ndeps == 0), 0
    while len(frontier):
        level[frontier] = lev
        np.subtract.at(ndeps, radj[frontier].indices, 1)
        ndeps[frontier] = -1
        frontier, lev = np.flatnonzero(ndeps == 0), lev + 1
    return level


def _sweep(src, rows, pos, level, entries, own, a, b, transpose_b, finish):
    """The factorization sweep, a step for each (row level, position in
    the row): every block e of `entries` gets
    S = src[e] - sum over its triples of out[a] @ out[b] (out[b]^T with
    `transpose_b`), subtracted one by one in the triples' order (k
    ascending, as the JAX package's row sweep), then out[e] =
    finish(E, S) for the step's blocks E. The blocks a triple reads lie
    earlier in the same row or in a row of an earlier level, so they are
    final when read. Returns out."""
    out = np.zeros_like(src)
    width = int(pos.max()) + 1 if len(pos) else 1
    key = level[rows[entries]] * width + pos[entries]
    order = np.argsort(key, kind="stable")
    E_all, key = entries[order], key[order]
    cuts = np.concatenate(([0], np.flatnonzero(np.diff(key)) + 1,
                           [len(key)]))
    step = np.full(len(src), -1, np.int64)
    step[E_all] = np.repeat(np.arange(len(cuts) - 1), np.diff(cuts))
    t_order = np.lexsort((np.arange(len(own)), own, step[own]))
    own, a, b = own[t_order], a[t_order], b[t_order]
    t_cuts = np.searchsorted(step[own], np.arange(len(cuts)))
    local = np.zeros(len(src), np.int64)
    for g in range(len(cuts) - 1):
        E = E_all[cuts[g]:cuts[g + 1]]
        S = src[E]                      # a copy (fancy indexing)
        lo, hi = t_cuts[g], t_cuts[g + 1]
        if hi > lo:
            local[E] = np.arange(len(E))
            B = out[b[lo:hi]]
            prods = out[a[lo:hi]] @ (B.transpose(0, 2, 1) if transpose_b
                                     else B)
            np.subtract.at(S, local[own[lo:hi]], prods)
        out[E] = finish(E, S)
    return out


def _positions(bindptr, brows, nnzb):
    return np.arange(nnzb) - bindptr[brows]


def bsrilu0(A):
    """Block ILU(0): zero-fill incomplete LU over the BLOCK pattern (the
    IKJ sweep; each operation a dense (bd, bd) product or inverse).

    Returns (L_blocks, U_blocks, inv_diag): the strictly block-lower and
    the block-upper parts as ((nnzb, bd, bd) values, block columns, block
    rows) numpy triplets, and the (nrowb, bd, bd) inverses of U's
    diagonal blocks (reference: rocsparse_bsrilu0)."""
    blocks, bcols, brows, bindptr, nrowb, bd = _bcsr_host(A)
    keys = brows * nrowb + bcols
    diag = _lookup(keys, np.arange(nrowb) * (nrowb + 1))
    if np.any(diag < 0):
        raise ValueError(f"block row {int(np.argmax(diag < 0))} has no "
                         "diagonal block")
    # triples (e = (i, j), a = (i, k), b = (k, j)) for every lower block a
    # and every block b of row k right of its diagonal, where (i, j) is a
    # block: e -= L_ik U_kj
    low = np.flatnonzero(bcols < brows)
    owner, bpos = _row_entries(bindptr, bcols[low])
    a = low[owner]
    right = bcols[bpos] > bcols[a]
    a, bpos = a[right], bpos[right]
    e = _lookup(keys, brows[a] * nrowb + bcols[bpos])
    hit = e >= 0
    dinv = np.zeros((nrowb, bd, bd), blocks.dtype)

    def finish(E, S):
        r, c = brows[E], bcols[E]
        out = S.copy()
        lo, dg = c < r, c == r
        out[lo] = S[lo] @ dinv[c[lo]]             # L_ik = A_ik inv(U_kk)
        dinv[r[dg]] = np.linalg.inv(S[dg])
        return out

    out = _sweep(blocks, brows, _positions(bindptr, brows, len(blocks)),
                 _row_levels(bcols, brows, nrowb), np.arange(len(blocks)),
                 e[hit], a[hit], bpos[hit], False, finish)
    lower = brows > bcols

    def _triplet(mask):
        return out[mask], bcols[mask], brows[mask]
    return _triplet(lower), _triplet(~lower), dinv


def bsric0(A):
    """Block IC(0): zero-fill incomplete Cholesky over the BLOCK pattern
    (A ~ L_b L_b^T with lower-triangular Cholesky diagonal blocks).
    Returns the ((nnzb_l, bd, bd) blocks incl. the diagonal, cols, rows)
    numpy triplet of the block-lower factor (reference: rocsparse_bsric0).
    L_ij = S inv(L_jj)^T multiplies by the inverse formed once a block
    row, where the JAX package solves with L_jj for every block (the same
    matrix, to rounding)."""
    blocks, bcols, brows, bindptr, nrowb, bd = _bcsr_host(A)
    keys = brows * nrowb + bcols
    # triples (e = (i, j), a = (i, k), b = (j, k)) for every lower block e
    # and every block b of row j left of its diagonal, where (i, k) is a
    # block: e -= L_ik L_jk^T
    low = np.flatnonzero(bcols <= brows)
    owner, bpos = _row_entries(bindptr, bcols[low])
    own = low[owner]
    left = bcols[bpos] < bcols[own]
    own, bpos = own[left], bpos[left]
    a = _lookup(keys, brows[own] * nrowb + bcols[bpos])
    hit = a >= 0
    inv_t = np.zeros((nrowb, bd, bd), blocks.dtype)

    def finish(E, S):
        r, c = brows[E], bcols[E]
        out = S.copy()
        off, dg = c < r, c == r
        out[off] = S[off] @ inv_t[c[off]]
        out[dg] = np.linalg.cholesky(S[dg])
        inv_t[r[dg]] = np.linalg.inv(out[dg]).transpose(0, 2, 1)
        return out

    out = _sweep(blocks, brows, _positions(bindptr, brows, len(blocks)),
                 _row_levels(bcols, brows, nrowb), low, own[hit], a[hit],
                 bpos[hit], True, finish)
    return out[low], bcols[low], brows[low]
