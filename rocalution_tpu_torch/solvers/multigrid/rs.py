"""Classical Ruge-Stüben AMG.

Counterpart of rocalution_tpu/solvers/multigrid/rs.py (reference:
RugeStuebenAMG, ruge_stueben_amg.{hpp,cpp} — SetStrengthThreshold
(default 0.25), SetCoarseningStrategy (Greedy | PMIS),
SetInterpolationType (Direct | ExtPI), ruge_stueben_amg.hpp:63-75; host
kernels RSCoarsening / RSPMISCoarsening / RSDirect / ExtPIInterpolation,
host_matrix_csr.cpp; device PMIS kernels, hip_rsamg_csr.cpp). The setup is
the JAX package's host code as is: vectorized numpy and scipy, the greedy
sweep through the shared native layer, with numpy's ``default_rng``
draws, so both packages build the same C/F maps, P, R and Ac. The
"pmis-device" coarsening runs its Luby rounds on the operator's device
(aggregation_device.py). The levels are host-resident CSRs until a cycle
closure places them.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ...formats import CSR
from ...formats.base import get_host


def _scipy(A: CSR):
    import scipy.sparse as sp

    return sp.csr_matrix(
        (get_host(A, "data"), get_host(A, "indices").astype(np.int64),
         get_host(A, "indptr").astype(np.int64)), shape=A.shape,
    )


def classical_strength(S, theta: float = 0.25):
    """Classical strength-of-connection: i strongly depends on j if
    -a_ij >= theta * max_k(-a_ik) (reference: RS strength computation)."""
    import scipy.sparse as sp

    n = S.shape[0]
    C = S.tocoo()
    offd = C.row != C.col
    neg = np.where(offd, -C.data, -np.inf)
    # per-row max of -a_ik over off-diagonals
    row_max = np.full(n, 0.0)
    np.maximum.at(row_max, C.row, np.where(offd, neg, 0.0))
    keep = offd & (neg >= theta * row_max[C.row]) & (neg > 0)
    return sp.csr_matrix(
        (np.ones(keep.sum(), np.int8), (C.row[keep], C.col[keep])),
        shape=S.shape,
    )


def pmis_coarsening(Sgraph, seed: int = 0) -> np.ndarray:
    """PMIS C/F splitting (reference: RSPMISCoarsening — random-weight Luby
    rounds on the strength graph). Returns cfmap: True = C point."""
    import scipy.sparse as sp

    n = Sgraph.shape[0]
    ST = Sgraph.T.tocsr()
    G = ((Sgraph + ST) > 0).astype(np.int8).tocsr()
    rng = np.random.default_rng(seed)
    # weight = number of points i strongly influences + random tiebreak
    lam = np.asarray(ST.sum(axis=1)).ravel().astype(np.float64)
    w = lam + rng.random(n)
    cf = np.zeros(n, np.int8)            # 0 undecided, 1 C, 2 F
    # isolated points (no strong connections at all) become C immediately
    iso = (np.diff(G.indptr) == 0)
    cf[iso] = 1
    undecided = cf == 0
    while undecided.any():
        wa = np.where(undecided, w, -np.inf)
        nbr_max = np.full(n, -np.inf)
        ne = np.diff(G.indptr) > 0
        if G.nnz:
            red = np.maximum.reduceat(wa[G.indices], G.indptr[:-1][ne])
            nbr_max[ne] = red
        sel = undecided & (w > nbr_max)
        cf[sel] = 1
        # any undecided point strongly depending on a new C point -> F
        idx = np.where(sel)[0]
        if len(idx):
            dep = ST[idx].indices        # points that depend on these C
            newf = np.zeros(n, bool)
            newf[dep] = True
            cf[(cf == 0) & newf] = 2
        undecided = cf == 0
        if not sel.any():
            cf[undecided] = 1            # safety: no progress -> all C
            break
    return cf == 1


def greedy_coarsening(Sgraph, second_pass: bool = True) -> np.ndarray:
    """Classical greedy Ruge-Stueben C/F splitting (reference:
    RSCoarsening, host_matrix_csr.cpp:6782 — Stuben's two-pass algorithm):
    repeatedly pick the undecided point influencing the most others as C,
    make its dependents F, and raise the weight of those dependents'
    dependencies; optional second pass promotes one point of every strong
    F-F pair without a common C. Sequential by nature -> native C++ sweep,
    with a per-node Python fallback. Returns cfmap: True = C point."""
    from ... import native

    n = Sgraph.shape[0]
    ST = Sgraph.T.tocsr()
    ST.sort_indices()
    # fully isolated points (no strong links either way) are pre-forced F:
    # nothing interpolates from them and they interpolate from nothing
    iso = (np.diff(Sgraph.indptr) == 0) & (np.diff(ST.indptr) == 0)
    cf = np.where(iso, np.int8(2), np.int8(0))
    if native.available():
        cf = native.rs_coarsening(Sgraph.indptr, Sgraph.indices,
                                  ST.indptr, ST.indices, cf, second_pass)
        return cf == 1
    # numpy fallback (same algorithm, heap-free reference implementation;
    # tie-break = LARGEST index among max-lambda nodes, matching the
    # native sweep's std::set<(lambda, node)> max-end pop so both produce
    # the identical C/F split — tested in test_amg.py)
    lam = np.where(cf == 0, np.diff(ST.indptr), -1).astype(np.int64)
    sp_, si_ = Sgraph.indptr, Sgraph.indices
    tp_, ti_ = ST.indptr, ST.indices
    while True:
        i = n - 1 - int(np.argmax(lam[::-1]))
        if lam[i] < 0:
            break
        cf[i] = 1
        lam[i] = -1
        for j in ti_[tp_[i]:tp_[i + 1]]:
            if cf[j] == 0:
                cf[j] = 2
                lam[j] = -1
                for l in si_[sp_[j]:sp_[j + 1]]:
                    if cf[l] == 0:
                        lam[l] += 1
        for l in si_[sp_[i]:sp_[i + 1]]:
            if cf[l] == 0:
                lam[l] -= 1
    if second_pass:
        for i in range(n):
            if cf[i] != 2:
                continue
            Ci = set(si_[sp_[i]:sp_[i + 1]][cf[si_[sp_[i]:sp_[i + 1]]] == 1])
            for j in si_[sp_[i]:sp_[i + 1]]:
                if cf[j] != 2:
                    continue
                Cj = si_[sp_[j]:sp_[j + 1]][cf[si_[sp_[j]:sp_[j + 1]]] == 1]
                if not Ci.intersection(Cj):
                    cf[j] = 1
                    Ci.add(j)
    return cf == 1


def _sample(M, rows, cols) -> np.ndarray:
    """Values of sparse M at the given (rows, cols) positions, 0 if absent
    (vectorized sorted-key lookup)."""
    M = M.tocsr()
    M.sort_indices()
    ncol = M.shape[1]
    mrow = np.repeat(np.arange(M.shape[0], dtype=np.int64),
                     np.diff(M.indptr))
    mkeys = mrow * ncol + M.indices.astype(np.int64)
    keys = rows.astype(np.int64) * ncol + cols.astype(np.int64)
    pos = np.searchsorted(mkeys, keys)
    pos_safe = np.minimum(pos, max(len(mkeys) - 1, 0))
    hit = (len(mkeys) > 0) & (mkeys[pos_safe] == keys)
    out = np.zeros(len(keys), M.dtype)
    out[hit] = M.data[pos_safe[hit]]
    return out


def extpi_interpolation(S, Sgraph, cfmap: np.ndarray, ff1: bool = False):
    """Extended+i (distance-two) interpolation (reference:
    RSExtPIInterpolation, local_matrix.hpp:1226 / host_matrix_csr.cpp:8122;
    algorithm per De Sterck, Yang & Heys, "Distance-two interpolation for
    parallel algebraic multigrid", 2008).

    For an F point i with strong C neighbors C_i and strong F neighbors
    F_i^s, the interpolatory set is the extended C_hat_i = C_i U (U_j C_j
    over j in F_i^s); with the FF1 limit only the FIRST strong C neighbor
    of each j extends the set (ruge_stueben_amg.hpp SetInterpolationFF1Limit
    semantics). Weights:

        w_ik = -( a_ik + sum_j a_ij abar_jk / d_ij ) / atilde_ii
        d_ij = sum_{l in C_hat_i U {i}} abar_jl
        atilde_ii = a_ii + sum_{weak, not in C_hat_i} a_ij
                    + sum_j a_ij abar_ji / d_ij

    where abar_jk drops entries whose sign matches the diagonal a_jj.
    Fully vectorized: two sparse products + sorted-key sampling.
    """
    import scipy.sparse as sp

    n = S.shape[0]
    fmask = ~cfmap
    frows = np.flatnonzero(fmask)
    nF = len(frows)
    coarse_idx = np.cumsum(cfmap) - 1
    nc = int(cfmap.sum())

    S = S.tocsr()
    S.sort_indices()
    diag = S.diagonal()

    # sign-filtered Abar: drop off-diagonal entries matching diag's sign
    Ac = S.tocoo()
    offd = Ac.row != Ac.col
    same_sign = np.sign(Ac.data) == np.sign(diag[Ac.row])
    keep = offd & ~same_sign
    Abar = sp.csr_matrix(
        (Ac.data[keep], (Ac.row[keep], Ac.col[keep])), shape=S.shape
    )

    # strong C / strong F patterns restricted to F rows
    Sg = Sgraph.tocsr()
    Sgc = Sg.multiply(cfmap[None, :]).tocsr()          # strong C neighbors
    Sgf = Sg.multiply(fmask[None, :]).tocsr()          # strong F neighbors
    # with FF1: only the first strong C neighbor of each F point extends
    # the set (column order, matching the reference's early loop break)
    Sgc_ext = _keep_first_per_row(Sgc) if ff1 else Sgc
    SgcF = Sgc[frows]
    SgfF = Sgf[frows]

    # extended interpolatory pattern C_hat (F rows x n), boolean
    M = ((SgcF + SgfF @ Sgc_ext) > 0).astype(np.float64).tocsr()

    # d_ij = (M @ Abar^T)_ij + abar_ji,  on the strong-F pattern
    AbarT = Abar.T.tocsr()
    D2 = (M @ AbarT).tocsr()
    Sf = SgfF.tocoo()
    fi, fj = Sf.row, Sf.col                   # fi: F-local row, fj: global col
    abar_ji = _sample(AbarT, frows[fi], fj)   # abar_{j,i} (the "+i" term)
    d = _sample(D2, fi, fj) + abar_ji
    a_ij = _sample(S, frows[fi], fj)
    ok = d != 0
    wf = np.where(ok, a_ij / np.where(ok, d, 1.0), 0.0)
    Wf = sp.csr_matrix((wf, (fi, fj)), shape=(nF, n))

    # numerator: a_ik (k in C_hat) + sum_j wf_ij abar_jk masked to C_hat
    AF = S[frows]
    numer = (AF.multiply(M > 0) + (Wf @ Abar).multiply(M > 0)).tocsr()

    # atilde_ii = a_ii + sum_{weak offd not in C_hat, not strong-F} a_ij
    #             + sum_j wf_ij abar_ji  (+ a_ij lumped where d_ij == 0)
    rowsum_offd = np.asarray(AF.sum(axis=1)).ravel() - diag[frows]
    sum_chat = np.asarray(AF.multiply(M > 0).sum(axis=1)).ravel()
    sum_strongF = np.asarray(AF.multiply(SgfF > 0).sum(axis=1)).ravel()
    corr = np.zeros(nF)
    np.add.at(corr, fi, wf * abar_ji)
    lump_back = np.zeros(nF)
    np.add.at(lump_back, fi[~ok], a_ij[~ok])
    atilde = (diag[frows] + rowsum_offd - sum_chat - sum_strongF
              + corr + lump_back)

    Nc = numer.tocoo()
    safe = atilde != 0
    wvals = -Nc.data / np.where(safe[Nc.row], atilde[Nc.row], 1.0)
    wvals[~safe[Nc.row]] = 0.0
    rows = frows[Nc.row]
    cols = coarse_idx[Nc.col]
    crows = np.flatnonzero(cfmap)
    P = sp.csr_matrix(
        (np.concatenate([wvals, np.ones(nc, S.dtype)]),
         (np.concatenate([rows, crows]),
          np.concatenate([cols, coarse_idx[crows]]))),
        shape=(n, nc),
    )
    return P


def _keep_first_per_row(C):
    """CSR with only the first stored entry of each row kept."""
    import scipy.sparse as sp

    nzrows = np.flatnonzero(np.diff(C.indptr) > 0)
    first = C.indptr[nzrows]
    return sp.csr_matrix(
        (np.ones(len(first), np.int8), (nzrows, C.indices[first])),
        shape=C.shape,
    )


def direct_interpolation(S, Sgraph, cfmap: np.ndarray):
    """Direct interpolation (reference: RSDirectInterpolation):
    F point i: w_ij = -(alpha|beta) a_ij / a_ii over strong C neighbors,
    alpha/beta = row sums of all negative/positive off-diagonals divided by
    the corresponding sums over the interpolatory set. C points: identity.
    """
    import scipy.sparse as sp

    n = S.shape[0]
    coarse_idx = np.cumsum(cfmap) - 1      # C index per row (valid where C)
    nc = int(cfmap.sum())
    from .aggregation import _pattern_member

    A = S.tocoo()
    offd = A.row != A.col
    strong = (_pattern_member(Sgraph, A.row, A.col)
              if Sgraph.nnz else np.zeros(len(A.row), bool))
    interp = offd & strong & cfmap[A.col]

    neg = A.data < 0
    pos = (A.data > 0) & offd
    sum_neg = np.zeros(n); sum_pos = np.zeros(n)
    np.add.at(sum_neg, A.row[offd & neg], A.data[offd & neg])
    np.add.at(sum_pos, A.row[pos], A.data[pos])
    sum_neg_C = np.zeros(n); sum_pos_C = np.zeros(n)
    np.add.at(sum_neg_C, A.row[interp & neg], A.data[interp & neg])
    np.add.at(sum_pos_C, A.row[interp & pos], A.data[interp & pos])
    diag = np.zeros(n)
    np.add.at(diag, A.row[~offd], A.data[~offd])
    # positive off-diagonals with no positive interpolatory entries get
    # lumped into the diagonal (standard direct-interp treatment)
    no_posC = sum_pos_C == 0
    diag_eff = diag + np.where(no_posC, sum_pos, 0.0)

    alpha = np.where(sum_neg_C != 0,
                     sum_neg / np.where(sum_neg_C == 0, 1, sum_neg_C), 0.0)
    beta = np.where(sum_pos_C != 0,
                    sum_pos / np.where(sum_pos_C == 0, 1, sum_pos_C), 0.0)

    sel = interp & ~cfmap[A.row]
    rfac = np.where(A.data[sel] < 0, alpha[A.row[sel]], beta[A.row[sel]])
    wvals = -rfac * A.data[sel] / diag_eff[A.row[sel]]
    rows = A.row[sel]
    cols = coarse_idx[A.col[sel]]
    # C rows: identity
    crows = np.where(cfmap)[0]
    P = sp.csr_matrix(
        (np.concatenate([wvals, np.ones(nc, S.dtype)]),
         (np.concatenate([rows, crows]),
          np.concatenate([cols, coarse_idx[crows]]))),
        shape=(n, nc),
    )
    return P


def rs_level(A: CSR, *, theta: float = 0.25, seed: int = 0,
             coarsening: str = "pmis", interpolation: str = "direct",
             ff1_limit: bool = False) -> Tuple[CSR, CSR, CSR]:
    """One RS coarsening step: returns (P, R, Ac).

    ``coarsening``: "pmis" (parallel Luby rounds) | "greedy" (classical
    two-pass, native sweep); ``interpolation``: "direct" | "extpi";
    ``ff1_limit`` limits ExtPI's extended set to one C point per F-F path
    (reference: ruge_stueben_amg.hpp:63-75 SetCoarseningStrategy /
    SetInterpolationType / SetInterpolationFF1Limit).
    """
    S = _scipy(A)
    Sg = classical_strength(S, theta)
    if coarsening == "greedy":
        cfmap = greedy_coarsening(Sg, second_pass=(interpolation == "direct"))
    elif coarsening == "pmis":
        cfmap = pmis_coarsening(Sg, seed)
    elif coarsening == "pmis-device":
        # Luby rounds on A's device (hip_rsamg RSPMISCoarsening analog)
        from .aggregation_device import pmis_coarsening_device

        cfmap = pmis_coarsening_device(Sg, seed, A.device)
    else:
        raise ValueError(f"unknown coarsening strategy {coarsening!r}")
    if cfmap.all() or not cfmap.any():
        raise ValueError("RS coarsening failed to split C/F")
    if interpolation == "direct":
        P = direct_interpolation(S, Sg, cfmap)
    elif interpolation == "extpi":
        P = extpi_interpolation(S, Sg, cfmap, ff1=ff1_limit)
    else:
        raise ValueError(f"unknown interpolation type {interpolation!r}")
    from ...ops.spgemm import spmm_host

    R = P.T.tocsr()
    Ac = spmm_host(spmm_host(R, S), P)
    from .aggregation import _to_csr

    return _to_csr(P), _to_csr(R), _to_csr(Ac)
