"""Standalone distributed matrix operations (setup phase).

Counterpart of rocalution_tpu/parallel/matops.py (reference:
GlobalMatrix::Transpose and GlobalMatrix::TripleMatrixProduct,
src/base/global_matrix.hpp:212-219): host-side sweeps over the per-part
row blocks with explicit exchanges (the CommunicateCSRAsync_ analog).
Every GlobalCSR built by `global_csr_from_blocks`/`distribute_csr`
carries its host block cache, so no device memory is read back. Keyword
arguments go to `global_csr_from_blocks` (``wjd``, ``device``, ...).
"""

from __future__ import annotations

import numpy as np

from .amg_setup import _blocks_of, _fetch_rows, _offsets
from .partition import GlobalCSR, global_csr_from_blocks


def _block_cache(Ag: GlobalCSR):
    cache = getattr(Ag, "_block_cache", None)
    if cache is None:
        raise ValueError(
            "GlobalCSR carries no host block cache (read from files or "
            "built per process): "
            "distributed Transpose/TripleMatrixProduct are setup-phase "
            "host ops — construct the operand via distribute_csr / "
            "global_csr_from_blocks")
    return cache              # (list of scipy CSR (nl_p, ncol_global), offs)


def _transpose_exchange(mats, offs, col_offs):
    """Bucket every entry to the owner of its column under `col_offs`
    (the inverse boundary-row CSR exchange, global_matrix.cpp:4041-4311):
    returns per-part blocks of the TRANSPOSE on the `col_offs` row
    partition."""
    import scipy.sparse as sp

    Pn = len(col_offs) - 1
    N = int(offs[-1])
    sends = [[] for _ in range(Pn)]
    for p, m in enumerate(mats):
        coo = m.tocoo()
        dest = np.searchsorted(col_offs, coo.col, side="right") - 1
        for q in np.unique(dest):
            sel = dest == q
            sends[q].append((coo.col[sel] - col_offs[q],
                             coo.row[sel] + offs[p], coo.data[sel]))
    out = []
    dt = mats[0].dtype.type if mats else np.float64
    for q in range(Pn):
        nr_q = int(col_offs[q + 1] - col_offs[q])
        if sends[q]:
            rr = np.concatenate([s[0] for s in sends[q]])
            rc = np.concatenate([s[1] for s in sends[q]])
            rd = np.concatenate([s[2] for s in sends[q]])
        else:
            rr = rc = np.zeros(0, np.int64)
            rd = np.zeros(0, dt)
        out.append(sp.csr_matrix((rd, (rr, rc)), shape=(nr_q, N)))
    return out


def global_transpose(Ag: GlobalCSR, **kwargs) -> GlobalCSR:
    """A^T of a distributed operator (reference: GlobalMatrix::Transpose,
    global_matrix.hpp:212). Rows of the result follow the EQUAL partition
    of A's columns."""
    mats, offs = _block_cache(Ag)
    kwargs.setdefault("device", Ag.device)
    ncol = Ag.n_global_col or Ag.n_global
    col_offs = _offsets(Ag.nparts, ncol)
    t_mats = _transpose_exchange(mats, offs, col_offs)
    return global_csr_from_blocks(
        _blocks_of(t_mats), (ncol, int(offs[-1])), **kwargs)


def global_triple_product(Rg: GlobalCSR, Ag: GlobalCSR, Pg: GlobalCSR,
                          **kwargs) -> GlobalCSR:
    """R·A·P of distributed operators (reference:
    GlobalMatrix::TripleMatrixProduct, global_matrix.hpp:219): AP with
    owner-fetched ghost rows of P, then R·(AP) with owner-fetched rows —
    the same exchange pattern the distributed AMG setup uses, exposed as
    a standalone op."""
    R_mats, r_offs = _block_cache(Rg)
    A_mats, a_offs = _block_cache(Ag)
    P_mats, p_offs = _block_cache(Pg)
    kwargs.setdefault("device", Ag.device)
    NC = Pg.n_global_col or Pg.n_global

    AP = []
    for p, m in enumerate(A_mats):
        Pfull = _fetch_rows(P_mats, p_offs, np.unique(m.tocoo().col), NC)
        AP.append((m @ Pfull).tocsr())

    out = []
    for q, Rq in enumerate(R_mats):
        cols = np.unique(Rq.tocoo().col)
        APfull = _fetch_rows(AP, a_offs, cols, NC)
        out.append((Rq @ APfull).tocsr())
    NR = int(r_offs[-1])
    return global_csr_from_blocks(_blocks_of(out), (NR, NC), **kwargs)
