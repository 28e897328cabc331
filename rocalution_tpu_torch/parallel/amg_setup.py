"""Distributed AMG setup from per-part row blocks, and its cycle.

Counterpart of rocalution_tpu/parallel/amg_setup.py (reference: the
Global AMG hierarchy build: each rank coarsens its OWN rows and exchanges
only boundary data, the ghost aggregate ids (parallel_manager.hpp:181-207),
boundary rows of P for the Galerkin product and transposed P entries for
R (global_matrix.cpp:1444-1495, 4041-4311), then derives the coarse-level
ParallelManager, parallel_manager.hpp:204-212).

The setup is the JAX package's host sweep, copied: numpy/scipy over the
per-part row blocks, never assembling a level as one matrix, with three
exchange helpers in place of the reference's point-to-point messages
(`_fetch_rows`, the gathered diag/agg vectors, the transpose bucketing).
Aggregation and the RS C/F split are DECOUPLED (they never cross a part
boundary; ROADMAP fault 4 keeps the reference's choice); smoothing and
the Galerkin product couple the parts through the exchanged rows, so the
coarse operator is the true R A P of the fine one.

The cycle (`dist_cycle_closure`) runs on this process's parts end to end
through `shard_spmv` and communicator reductions. Its coarsest solve is a
fixed number of Jacobi-preconditioned CG steps on the sharded coarsest
operator, not a replicated dense inverse. The level operators take the
auto rule for their interior plans; the transfers are built with
``wjd=False`` and keep the plain segment sum, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import resolve_device
from ..formats import CSR
from ..formats.base import to_device
from ..solvers.krylov._common import safe_div
from ..solvers.multigrid.aggregation import _aggregate, strength_connect
from .comm import StackedComm
from .ops import shard_spmv
from .partition import GlobalCSR, global_csr_from_blocks


class DistLevels(NamedTuple):
    """Distributed hierarchy built from per-part data."""

    As: Tuple[GlobalCSR, ...]          # operators, finest first
    Ps: Tuple[GlobalCSR, ...]          # prolongations
    Rs: Tuple[GlobalCSR, ...]          # restrictions
    inv_diags: Tuple[torch.Tensor, ...]  # (P, nl) smoother diagonals
    coarse_inv_diag: torch.Tensor      # (P, nl_c) Jacobi of the coarse CG


def _offsets(nparts: int, n: int) -> np.ndarray:
    nl = -(-n // nparts)
    return np.minimum(np.arange(nparts + 1, dtype=np.int64) * nl, n)


def _fetch_rows(mats, offs, rows_needed: np.ndarray, ncol: int):
    """Assemble a row-restricted sparse matrix (shape (N, ncol), only
    `rows_needed` populated) from the owning parts — each owner 'sends'
    its requested rows (CommunicateCSRAsync_ analog)."""
    import scipy.sparse as sp

    N = int(offs[-1])
    if len(rows_needed) == 0:
        return sp.csr_matrix((N, ncol))
    rows_needed = np.unique(rows_needed)
    owner = np.searchsorted(offs, rows_needed, side="right") - 1
    parts = []
    for p in np.unique(owner):
        loc = rows_needed[owner == p] - offs[p]
        sub = mats[p][loc].tocoo()
        parts.append((offs[p] + loc[sub.row], sub.col, sub.data))
    r = np.concatenate([x[0] for x in parts])
    c = np.concatenate([x[1] for x in parts])
    d = np.concatenate([x[2] for x in parts])
    return sp.csr_matrix((d, (r, c)), shape=(N, ncol))


def dist_sa_level(mats: Sequence, offs: np.ndarray, *, eps: float = 0.08,
                  omega: float = 2.0 / 3.0, strategy: str = "auto",
                  lumping: bool = True, seed: int = 0):
    """One distributed smoothed-aggregation coarsening step.

    `mats[p]`: scipy CSR of part p's rows (nl_p × N, GLOBAL columns).
    Returns (P_mats, R_mats, Ac_mats, coffs) — per-part row blocks of the
    transfer operators and the coarse operator, plus coarse row offsets.
    """
    import scipy.sparse as sp

    Pn = len(mats)
    N = int(offs[-1])

    # ghost-column diagonal exchange (reference: boundary diag values ride
    # the vector communicator) — gathered as one O(N) vector per host
    diag = np.concatenate(
        [mats[p].diagonal(int(offs[p])) for p in range(Pn)])

    # decoupled aggregation on each part's diagonal block
    aggs, ncs = [], []
    for p in range(Pn):
        local = mats[p][:, offs[p]:offs[p + 1]].tocsr()
        C = strength_connect(local, eps)
        agg = _aggregate(C, strategy, seed + p)
        aggs.append(agg)
        ncs.append(int(agg.max()) + 1 if len(agg) else 0)
    coffs = np.concatenate([[0], np.cumsum(ncs)]).astype(np.int64)
    NC = int(coffs[-1])
    # global aggregate-id vector (ghost aggregate-id exchange;
    # parallel_manager.hpp ghost->global maps)
    agg_gid = (np.concatenate([coffs[p] + aggs[p] for p in range(Pn)])
               if N else np.zeros(0, np.int64))

    P_mats, AP_mats = [], []
    for p in range(Pn):
        m = mats[p]
        nl_p = m.shape[0]
        coo = m.tocoo()
        grow = coo.row + offs[p]
        offd = coo.col != grow
        strong = np.abs(coo.data) >= eps * np.sqrt(
            np.abs(diag[grow] * diag[coo.col]))
        keep = ~offd | strong
        Af = sp.csr_matrix(
            (coo.data[keep], (coo.row[keep], coo.col[keep])),
            shape=(nl_p, N))
        if lumping:
            lump = np.zeros(nl_p, m.dtype.type)
            np.add.at(lump, coo.row[~keep], coo.data[~keep])
            Af = Af + sp.csr_matrix(
                (lump, (np.arange(nl_p), offs[p] + np.arange(nl_p))),
                shape=(nl_p, N))
        d = Af.diagonal(int(offs[p]))
        inv_d = np.where(d != 0, 1.0 / np.where(d == 0, 1.0, d), 1.0)
        # tentative T restricted to the rows this part touches (own +
        # ghost) — foreign aggregate ids come from the exchanged vector
        rows_needed = np.unique(
            np.concatenate([Af.tocoo().col, offs[p] + np.arange(nl_p)]))
        T_sub = sp.csr_matrix(
            (np.ones(len(rows_needed), m.dtype.type),
             (rows_needed, agg_gid[rows_needed])), shape=(N, NC))
        from ..ops.spgemm import spmm_host

        T_own = T_sub[offs[p]:offs[p + 1]]
        AfT = spmm_host(Af, T_sub)
        AfT.data *= omega * np.repeat(inv_d, np.diff(AfT.indptr))
        P_p = (T_own - AfT).tocsr()
        P_p.eliminate_zeros()
        P_mats.append(P_p)

    R_mats, Ac_mats = _dist_galerkin(mats, offs, P_mats, coffs)
    return P_mats, R_mats, Ac_mats, coffs


def _dist_galerkin(mats, offs, P_mats, coffs):
    """Distributed Galerkin product + transpose exchange shared by every
    distributed coarsening (SA/RS): AP with fetched ghost P rows, R = Pᵀ
    via bucketing each P entry to its coarse-row owner, Ac = R·AP
    (reference: boundary-row CSR exchange + triple product,
    global_matrix.cpp:4041-4311)."""
    import scipy.sparse as sp

    Pn = len(mats)
    N = int(offs[-1])
    NC = int(coffs[-1])

    from ..ops.spgemm import spmm_host

    # AP_p = A_p · P (ghost rows of P fetched from their owners)
    AP_mats = []
    for p in range(Pn):
        m = mats[p]
        Pfull = _fetch_rows(P_mats, offs, np.unique(m.tocoo().col), NC)
        AP_mats.append(spmm_host(m, Pfull))

    # R = Pᵀ: every part buckets its P entries to the owner of the coarse
    # row (inverse boundary-row exchange), then Ac_q = R_q · AP
    sends = [[] for _ in range(Pn)]
    for p in range(Pn):
        coo = P_mats[p].tocoo()
        dest = np.searchsorted(coffs, coo.col, side="right") - 1
        for q in np.unique(dest):
            sel = dest == q
            sends[q].append((coo.col[sel] - coffs[q],
                             coo.row[sel] + offs[p], coo.data[sel]))
    R_mats, Ac_mats = [], []
    for q in range(Pn):
        nc_q = int(coffs[q + 1] - coffs[q])
        if sends[q]:
            rr = np.concatenate([s[0] for s in sends[q]])
            rc = np.concatenate([s[1] for s in sends[q]])
            rd = np.concatenate([s[2] for s in sends[q]])
        else:
            rr = rc = np.zeros(0, np.int64)
            rd = np.zeros(0, mats[0].dtype.type)
        R_q = sp.csr_matrix((rd, (rr, rc)), shape=(nc_q, N))
        R_mats.append(R_q)
        APfull = _fetch_rows(AP_mats, offs, np.unique(rc), NC)
        Ac_mats.append(spmm_host(R_q, APfull))
    return R_mats, Ac_mats


def dist_rs_level(mats: Sequence, offs: np.ndarray, *, theta: float = 0.25,
                  coarsening: str = "pmis", interpolation: str = "direct",
                  ff1_limit: bool = False, seed: int = 0):
    """One distributed Ruge-Stüben coarsening step.

    Decoupled C/F splitting: each part runs classical strength + PMIS (or
    greedy) + direct/ExtPI interpolation on its DIAGONAL block — the
    subdomain-blocking variant of the reference's global RS build
    (global_matrix.cpp:1444-1495 RSCoarsening/RSDirectInterpolation at
    global scope; decoupled boundary treatment is the standard MPI-cheap
    choice). Cross-boundary coupling still enters the coarse operator
    through the full Galerkin product (exchanged AP/R rows), so Ac is the
    true R·A·P of the global fine operator.

    Returns (P_mats, R_mats, Ac_mats, coffs) like `dist_sa_level`.
    """
    import scipy.sparse as sp

    from ..solvers.multigrid.rs import (classical_strength,
                                        direct_interpolation,
                                        extpi_interpolation,
                                        greedy_coarsening, pmis_coarsening)

    Pn = len(mats)

    P_locs, ncs = [], []
    for p in range(Pn):
        local = mats[p][:, offs[p]:offs[p + 1]].tocsr()
        nl_p = local.shape[0]
        Sg = classical_strength(local, theta)
        if coarsening == "greedy":
            cfmap = greedy_coarsening(
                Sg, second_pass=(interpolation == "direct"))
        else:
            cfmap = pmis_coarsening(Sg, seed + p)
        if not cfmap.any():
            cfmap = np.ones(nl_p, bool)     # degenerate tiny part: all C
        if cfmap.all():
            P_loc = sp.identity(nl_p, format="csr",
                                dtype=local.dtype)
        elif interpolation == "extpi":
            P_loc = extpi_interpolation(local, Sg, cfmap, ff1=ff1_limit)
        else:
            P_loc = direct_interpolation(local, Sg, cfmap)
        P_locs.append(P_loc.tocsr())
        ncs.append(P_loc.shape[1])
    coffs = np.concatenate([[0], np.cumsum(ncs)]).astype(np.int64)
    NC = int(coffs[-1])

    # embed each local prolongation into the global coarse column space
    P_mats = []
    for p in range(Pn):
        coo = P_locs[p].tocoo()
        P_mats.append(sp.csr_matrix(
            (coo.data, (coo.row, coo.col + coffs[p])),
            shape=(P_locs[p].shape[0], NC)))

    R_mats, Ac_mats = _dist_galerkin(mats, offs, P_mats, coffs)
    return P_mats, R_mats, Ac_mats, coffs


def dist_ua_level(mats: Sequence, offs: np.ndarray, *, eps: float = 0.08,
                  strategy: str = "auto", seed: int = 0):
    """One distributed unsmoothed-aggregation coarsening step: decoupled
    aggregation per part (as `dist_sa_level`) but P is the raw tentative
    operator — no Jacobi smoothing, so no filtered-row exchange is needed;
    the Galerkin product still couples across boundaries. Completes the
    reference's global UAAMG (unsmoothed_amg.cpp, GlobalMatrix
    instantiations at end of file)."""
    import scipy.sparse as sp

    Pn = len(mats)
    aggs, ncs = [], []
    for p in range(Pn):
        local = mats[p][:, offs[p]:offs[p + 1]].tocsr()
        C = strength_connect(local, eps)
        agg = _aggregate(C, strategy, seed + p)
        aggs.append(agg)
        ncs.append(int(agg.max()) + 1 if len(agg) else 0)
    coffs = np.concatenate([[0], np.cumsum(ncs)]).astype(np.int64)
    NC = int(coffs[-1])
    P_mats = []
    for p in range(Pn):
        nl_p = mats[p].shape[0]
        P_mats.append(sp.csr_matrix(
            (np.ones(nl_p, mats[p].dtype.type),
             (np.arange(nl_p), coffs[p] + aggs[p])), shape=(nl_p, NC)))
    R_mats, Ac_mats = _dist_galerkin(mats, offs, P_mats, coffs)
    return P_mats, R_mats, Ac_mats, coffs


def dist_pairwise_level(mats: Sequence, offs: np.ndarray, *,
                        beta: float = 0.25, npass: int = 2,
                        seed: int = 0):
    """One distributed pairwise-aggregation (Notay) coarsening step:
    decoupled matching per part's diagonal block (the same
    subdomain-blocking treatment as `dist_rs_level`), exact global
    Galerkin through the exchange helpers. Completes the reference's
    global-scope AMG family (PairwiseAMG for GlobalMatrix,
    global_matrix.cpp:4041-4311)."""
    import scipy.sparse as sp

    from ..solvers.multigrid.aggregation import pairwise_level

    Pn = len(mats)
    P_locs, ncs = [], []
    for p in range(Pn):
        local = mats[p][:, offs[p]:offs[p + 1]].tocsr()
        loc = CSR.from_arrays(local.data, local.indices, local.indptr,
                              local.shape, device="cpu")
        Pl, _, _ = pairwise_level(loc, beta=beta, npass=npass,
                                  seed=seed + p)
        d, i, ptr = Pl.numpy_triplet()
        P_locs.append(sp.csr_matrix((d, i, ptr), shape=Pl.shape))
        ncs.append(Pl.shape[1])
    coffs = np.concatenate([[0], np.cumsum(ncs)]).astype(np.int64)
    NC = int(coffs[-1])
    P_mats = []
    for p in range(Pn):
        coo = P_locs[p].tocoo()
        P_mats.append(sp.csr_matrix(
            (coo.data, (coo.row, coo.col + coffs[p])),
            shape=(P_locs[p].shape[0], NC)))
    R_mats, Ac_mats = _dist_galerkin(mats, offs, P_mats, coffs)
    return P_mats, R_mats, Ac_mats, coffs



def _inv_diag_stacked(mats, offs, nparts, nl, device) -> torch.Tensor:
    out = np.ones((nparts, nl))
    for p in range(len(mats)):
        d = mats[p].diagonal(int(offs[p]))
        iv = np.where(d != 0, 1.0 / np.where(d == 0, 1.0, d), 1.0)
        out[p, :len(iv)] = iv
    return to_device(out.astype(mats[0].dtype), device)


def _blocks_of(mats) -> list:
    out = []
    for m in mats:
        coo = m.tocoo()
        out.append((coo.row.astype(np.int64), coo.col.astype(np.int64),
                    coo.data))
    return out


def _reblock(mats_uneven, row_offs, ncols: int, nparts: int):
    """Re-partition row blocks from an uneven row split (`row_offs`, e.g.
    the per-part aggregate counts) onto the equal block partition the
    GlobalCSR/vector layout uses — the coarse-PM derivation step
    (parallel_manager.hpp:204-212: coarse boundary indices re-homed)."""
    import scipy.sparse as sp

    NR = int(row_offs[-1])
    nl = -(-NR // nparts) if NR else 1
    eq_offs = _offsets(nparts, NR)
    buckets = [[] for _ in range(nparts)]
    for q, m in enumerate(mats_uneven):
        coo = m.tocoo()
        grow = coo.row + row_offs[q]
        dest = np.minimum(grow // nl, nparts - 1)
        for t in np.unique(dest):
            sel = dest == t
            buckets[t].append((grow[sel] - t * nl, coo.col[sel],
                               coo.data[sel]))
    out = []
    dt = mats_uneven[0].dtype.type if mats_uneven else np.float64
    for t in range(nparts):
        if buckets[t]:
            rr = np.concatenate([b[0] for b in buckets[t]])
            cc = np.concatenate([b[1] for b in buckets[t]])
            dd = np.concatenate([b[2] for b in buckets[t]])
        else:
            rr = cc = np.zeros(0, np.int64)
            dd = np.zeros(0, dt)
        out.append(sp.csr_matrix(
            (dd, (rr, cc)), shape=(int(eq_offs[t + 1] - eq_offs[t]), ncols)))
    return out, eq_offs

def distributed_amg_setup(blocks, shape, *, kind: str = "sa",
                          coarse_size: int = 300,
                          max_levels: int = 10, eps: float = 0.08,
                          omega: float = 2.0 / 3.0, strategy: str = "auto",
                          theta: float = 0.25,
                          interpolation: str = "direct",
                          seed: int = 0, wjd: Optional[bool] = None,
                          device=None) -> DistLevels:
    """Build a distributed AMG hierarchy from per-part row blocks, on
    ``device``.

    `kind`: "sa" (`dist_sa_level`), "rs" (`dist_rs_level`: decoupled C/F
    and direct/ExtPI interpolation; `theta` and `interpolation` apply),
    "ua" (`dist_ua_level`) or "pairwise" (`dist_pairwise_level`).
    `blocks[p]` = (local_rows, global_cols, values) for part p's rows,
    the block format of `global_csr_from_blocks`. Every level is a
    GlobalCSR; the coarsest keeps its Jacobi diagonal for the in-cycle
    CG. ``wjd`` plans the level operators' interiors (None = the auto
    rule, `partition.plans_interiors`); the transfers are never planned.
    """
    import scipy.sparse as sp

    device = resolve_device(device)
    Pn = len(blocks)
    N = int(shape[0])
    offs = _offsets(Pn, N)
    mats = []
    for p in range(Pn):
        r, c, d = blocks[p]
        mats.append(sp.csr_matrix(
            (d, (np.asarray(r), np.asarray(c))),
            shape=(int(offs[p + 1] - offs[p]), N)))

    As, Ps, Rs, invds = [], [], [], []
    level_mats, level_offs = mats, offs
    while len(As) < max_levels - 1 and int(level_offs[-1]) > coarse_size:
        Ag = global_csr_from_blocks(
            _blocks_of(level_mats), (int(level_offs[-1]),) * 2, wjd=wjd,
            device=device)
        if kind == "rs":
            P_m, R_m, Ac_m, coffs = dist_rs_level(
                level_mats, level_offs, theta=theta,
                interpolation=interpolation, seed=seed + len(As))
        elif kind == "ua":
            P_m, R_m, Ac_m, coffs = dist_ua_level(
                level_mats, level_offs, eps=eps * 0.5 ** len(As),
                strategy=strategy, seed=seed + len(As))
        elif kind == "pairwise":
            P_m, R_m, Ac_m, coffs = dist_pairwise_level(
                level_mats, level_offs, seed=seed + len(As))
        else:
            # eps halves per level like the serial setup (smoothed_amg
            # .cpp:263-267): a fixed eps stalls aggregation at depth
            P_m, R_m, Ac_m, coffs = dist_sa_level(
                level_mats, level_offs, eps=eps * 0.5 ** len(As),
                omega=omega, strategy=strategy, seed=seed + len(As))
        NC = int(coffs[-1])
        if NC >= int(level_offs[-1]):      # coarsening stalled
            break
        As.append(Ag)
        invds.append(_inv_diag_stacked(level_mats, level_offs, Pn,
                                       Ag.n_local, device))
        # the transfers keep the plain segment sum (wjd=False), as the JAX
        # package builds them
        Ps.append(global_csr_from_blocks(
            _blocks_of(P_m), (int(level_offs[-1]), NC), wjd=False,
            device=device))
        # R and Ac come out on the uneven per-part aggregate partition:
        # re-home them onto the equal coarse partition (coarse-PM
        # derivation)
        R_eq, _ = _reblock(R_m, coffs, int(level_offs[-1]), Pn)
        Rs.append(global_csr_from_blocks(
            _blocks_of(R_eq), (NC, int(level_offs[-1])), wjd=False,
            device=device))
        level_mats, level_offs = _reblock(Ac_m, coffs, NC, Pn)

    # coarsest level: sharded operator + Jacobi diagonal (no dense inverse)
    Ac_g = global_csr_from_blocks(
        _blocks_of(level_mats), (int(level_offs[-1]),) * 2, wjd=wjd,
        device=device)
    As.append(Ac_g)
    coarse_inv = _inv_diag_stacked(level_mats, level_offs, Pn, Ac_g.n_local,
                                   device)
    return DistLevels(tuple(As), tuple(Ps), tuple(Rs), tuple(invds),
                      coarse_inv)


def dist_levels_from_blocks(A_blocks, P_blocks, R_blocks, sizes, *,
                            wjd: Optional[bool] = None,
                            device=None) -> DistLevels:
    """Distributed GEOMETRIC multigrid: a DistLevels hierarchy from
    user-supplied per-level, per-part row blocks (the reference's
    MultiGrid for GlobalMatrix: SetOperator/SetRestrictOperator/
    SetProlongOperator per level). `A_blocks[l]`: blocks of level l's
    operator (`sizes[l]` unknowns, finest first); `P_blocks[l]`: of the
    prolongation (sizes[l] x sizes[l+1]); `R_blocks[l]`: of the
    restriction. All levels take the equal row partition over
    `len(A_blocks[0])` parts."""
    import scipy.sparse as sp

    device = resolve_device(device)
    nlev = len(A_blocks)
    if len(P_blocks) != nlev - 1 or len(R_blocks) != nlev - 1:
        raise ValueError("need exactly one P and R per fine level")
    Pn = len(A_blocks[0])

    def _mats(blocks, nrow, ncol):
        offs = _offsets(Pn, nrow)
        out = []
        for p in range(Pn):
            r, c, d = blocks[p]
            out.append(sp.csr_matrix(
                (np.asarray(d), (np.asarray(r), np.asarray(c))),
                shape=(int(offs[p + 1] - offs[p]), ncol)))
        return out, offs

    As, Ps, Rs, invds = [], [], [], []
    coarse_inv = None
    for l in range(nlev):
        n = int(sizes[l])
        mats, offs = _mats(A_blocks[l], n, n)
        Ag = global_csr_from_blocks(_blocks_of(mats), (n, n), wjd=wjd,
                                    device=device)
        As.append(Ag)
        if l < nlev - 1:
            invds.append(_inv_diag_stacked(mats, offs, Pn, Ag.n_local,
                                           device))
            nc = int(sizes[l + 1])
            Pm, _ = _mats(P_blocks[l], n, nc)
            Ps.append(global_csr_from_blocks(
                _blocks_of(Pm), (n, nc), wjd=False, device=device))
            Rm, _ = _mats(R_blocks[l], nc, n)
            Rs.append(global_csr_from_blocks(
                _blocks_of(Rm), (nc, n), wjd=False, device=device))
        else:
            coarse_inv = _inv_diag_stacked(mats, offs, Pn, Ag.n_local,
                                           device)
    return DistLevels(tuple(As), tuple(Ps), tuple(Rs), tuple(invds),
                      coarse_inv)


def dist_amg_solve_sharded(solver: Callable, dl: DistLevels, b, *,
                           comm=None, coarse_iters: int = 16,
                           cycle: str = "V", **solver_kwargs):
    """AMG-preconditioned solve over a DistLevels hierarchy (the
    reference's cg-amg_mpi flow with no global assembly). `comm` defaults
    to all parts in this process. Returns the global x and the info."""
    from .partition import distribute_vector, gather_vector
    from .ops import shard_operator

    Ag = dl.As[0]
    comm = StackedComm(Ag.nparts) if comm is None else comm
    bp = distribute_vector(b, Ag.nparts, Ag.n_local, device=Ag.device)
    M = dist_cycle_closure(dl, comm, coarse_iters=coarse_iters, cycle=cycle)
    x, info = solver(shard_operator(Ag, comm), bp.reshape(-1), None, M,
                     axis_name=comm, **solver_kwargs)
    return gather_vector(x.reshape(Ag.local_parts, -1), Ag.n_global), info


def dist_cycle_closure(dl: DistLevels, comm, *, omega: float = 2.0 / 3.0,
                       pre: int = 1, post: int = 2, coarse_iters: int = 16,
                       cycle: str = "V") -> Callable:
    """Multigrid cycle over a DistLevels hierarchy, as a closure over flat
    vectors of this process's parts. `cycle`: V | W | F | K, the serial
    engine's four (BaseMultiGrid Vcycle_/Wcycle_/Fcycle_/Kcycle_,
    base_multigrid.cpp:720-981) at global scope; K takes two flexible-CG
    steps on the coarse system with mesh-global reductions. The coarsest
    solve is `coarse_iters` fixed CG + Jacobi steps on the sharded
    coarsest operator."""
    nlev = len(dl.Ps)
    cyc = cycle.upper()
    if cyc not in ("V", "W", "F", "K"):
        raise ValueError(f"unknown cycle {cycle!r}")
    Pl = dl.As[0].local_parts

    def spmv(A, x):
        return shard_spmv(A, x.reshape(Pl, -1), comm).reshape(-1)

    invds = [v.reshape(-1) for v in dl.inv_diags]
    coarse_invd = dl.coarse_inv_diag.reshape(-1)

    def psum_dot(a, b):
        return comm.psum(torch.sum((a * b).reshape(Pl, -1), dim=1))

    def smooth(l, b, x, sweeps):
        for _ in range(sweeps):
            x = x + omega * invds[l] * (b - spmv(dl.As[l], x))
        return x

    def coarse_solve(b):
        A = dl.As[-1]
        z = coarse_invd * b
        x, r, pvec, rho = torch.zeros_like(b), b, z, psum_dot(b, z)
        for _ in range(coarse_iters):
            q = spmv(A, pvec)
            alpha = safe_div(rho, psum_dot(pvec, q))
            x = x + alpha * pvec
            r = r - alpha * q
            z = coarse_invd * r
            rho_n = psum_dot(r, z)
            beta = safe_div(rho_n, rho)
            pvec, rho = z + beta * pvec, rho_n
        return x

    def fcg_steps(l, b, inner, steps=2):
        """K-cycle: `steps` flexible-CG iterations on level l's system,
        preconditioned by the deeper cycle (Notay; reference
        SetKcycleFull), the serial engine's Polak-Ribiere form with
        mesh-global reductions."""
        A = dl.As[l]
        x = torch.zeros_like(b)
        r = b
        p = r_prev = rho = None
        for _ in range(steps):
            z = inner(r)
            if p is None:
                p = z
                rho = psum_dot(r, z)
            else:
                rho_new = psum_dot(r, z)
                beta = safe_div(rho_new - psum_dot(z, r_prev), rho)
                p = z + beta * p
                rho = rho_new
            q = spmv(A, p)
            alpha = safe_div(rho, psum_dot(p, q))
            x = x + alpha * p
            r_prev = r
            r = r - alpha * q
        return x

    def level_apply(l, b, mode):
        if l == nlev:
            return coarse_solve(b)
        x = smooth(l, b, torch.zeros_like(b), pre)
        res = b - spmv(dl.As[l], x)
        rc = spmv(dl.Rs[l], res)
        Ac = dl.As[l + 1]
        if l + 1 == nlev or mode == "V":
            e = level_apply(l + 1, rc, "V" if mode == "F" else mode)
        elif mode == "W":
            e = level_apply(l + 1, rc, "W")
            e = e + level_apply(l + 1, rc - spmv(Ac, e), "W")
        elif mode == "F":
            e = level_apply(l + 1, rc, "F")
            e = e + level_apply(l + 1, rc - spmv(Ac, e), "V")
        else:  # K
            e = fcg_steps(l + 1, rc, lambda r: level_apply(l + 1, r, "K"))
        x = x + spmv(dl.Ps[l], e)
        return smooth(l, b, x, post)

    return lambda r: level_apply(0, r, cyc)
