"""Matrix orderings and reorderings.

Counterpart of rocalution_tpu/ops/ordering.py (reference: LocalMatrix::
MultiColoring, MaximalIndependentSet, CMK/RCMK, ConnectivityOrder,
ZeroBlockPermutation and Permute, local_matrix.hpp:434-496). Orderings
are setup work on the host: they read the CSR's host arrays and return
numpy permutations and colour or set sizes, drawing their priorities from
numpy's ``default_rng`` exactly as the JAX package does, so both give the
same arrays; `permute_csr` builds the permuted CSR on the host and sends
it to its device once.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..formats import CSR
from ..formats.base import get_host


def _host_csr(A: CSR):
    data = get_host(A, "data")
    indices = get_host(A, "indices").astype(np.int64)
    indptr = get_host(A, "indptr").astype(np.int64)
    return data, indices, indptr


def multicoloring(A: CSR) -> Tuple[int, np.ndarray, np.ndarray]:
    """Greedy graph colouring of the symmetrized sparsity pattern.

    Returns (num_colors, permutation, block_sizes): `permutation[i]` is the
    new index of row i (rows sorted by colour), `block_sizes[c]` the number
    of rows of colour c (reference: LocalMatrix::MultiColoring,
    local_matrix.hpp:440-448)."""
    n = A.shape[0]
    colors = _jp_coloring(_sym_graph(A), n)
    ncol = int(colors.max()) + 1 if n else 0
    perm = _perm_of_order(np.argsort(colors, kind="stable"))
    return ncol, perm, np.bincount(colors, minlength=ncol)


def _sym_graph(A: CSR):
    import scipy.sparse as sp

    _, indices, indptr = _host_csr(A)
    G = sp.csr_matrix(
        (np.ones(len(indices), np.int8), indices, indptr), shape=A.shape
    )
    G = (G + G.T).tocsr()
    G.setdiag(0)
    G.eliminate_zeros()
    return G


def _neighbor_max(G, vals):
    """Per-row max of vals over the neighbour lists (vectorized
    reduceat)."""
    out = np.full(G.shape[0], -np.inf)
    nonempty = np.diff(G.indptr) > 0
    if G.nnz:
        out[nonempty] = np.maximum.reduceat(vals[G.indices],
                                            G.indptr[:-1][nonempty])
    return out


def _jp_coloring(G, n, seed: int = 0) -> np.ndarray:
    """Jones-Plassmann colouring: each round colours the priority-local
    maxima of the still uncoloured subgraph (the parallel greedy family of
    the reference's device MultiColoring kernels)."""
    rng = np.random.default_rng(seed)
    w = rng.permutation(n).astype(np.float64)    # unique priorities
    colors = np.full(n, -1, dtype=np.int64)
    active = np.ones(n, dtype=bool)
    c = 0
    while active.any():
        nbr_max = _neighbor_max(G, np.where(active, w, -np.inf))
        sel = active & (w > nbr_max)
        colors[sel] = c
        active[sel] = False
        c += 1
    return colors


def maximal_independent_set(A: CSR) -> Tuple[int, np.ndarray]:
    """Maximal independent set by Luby rounds: returns (mis_size,
    permutation) with the set's rows ordered first (reference:
    LocalMatrix::MaximalIndependentSet, local_matrix.hpp:455-462)."""
    n = A.shape[0]
    G = _sym_graph(A)
    w = np.random.default_rng(0).permutation(n).astype(np.float64)
    in_set = np.zeros(n, dtype=bool)
    candidate = np.ones(n, dtype=bool)
    while candidate.any():
        nbr_max = _neighbor_max(G, np.where(candidate, w, -np.inf))
        sel = candidate & (w > nbr_max)
        in_set |= sel
        candidate[sel] = False
        # the selected rows knock out their neighbourhood
        sel_idx = np.where(sel)[0]
        if len(sel_idx):
            knocked = np.zeros(n, dtype=bool)
            knocked[G[sel_idx].indices] = True
            candidate &= ~knocked
    order = np.concatenate([np.where(in_set)[0], np.where(~in_set)[0]])
    return int(in_set.sum()), _perm_of_order(order)


def connectivity_order(A: CSR) -> np.ndarray:
    """Order rows by increasing number of nonzeros (reference:
    LocalMatrix::ConnectivityOrder, local_matrix.hpp:471)."""
    _, _, indptr = _host_csr(A)
    return _perm_of_order(np.argsort(np.diff(indptr), kind="stable"))


def zero_block_permutation(A: CSR) -> Tuple[int, np.ndarray]:
    """Permutation placing a maximal set of mutually independent rows
    first, so that the leading diagonal block of the permuted matrix is
    diagonal (reference: LocalMatrix::ZeroBlockPermutation,
    local_matrix.hpp:478 — the MultiElimination building block). Returns
    (block_size, permutation)."""
    return maximal_independent_set(A)


def _rcm_order(A: CSR) -> np.ndarray:
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    _, indices, indptr = _host_csr(A)
    G = sp.csr_matrix(
        (np.ones(len(indices), np.int8), indices, indptr), shape=A.shape
    )
    return reverse_cuthill_mckee(G, symmetric_mode=False)


def _perm_of_order(order: np.ndarray) -> np.ndarray:
    """perm[old] = new for `order` listing the old index of each new row."""
    perm = np.empty(len(order), dtype=np.int64)
    perm[order] = np.arange(len(order))
    return perm


def cmk(A: CSR) -> np.ndarray:
    """Cuthill-McKee bandwidth-reducing permutation (reference:
    LocalMatrix::CMK)."""
    return _perm_of_order(_rcm_order(A)[::-1].copy())


def rcmk(A: CSR) -> np.ndarray:
    """Reverse Cuthill-McKee permutation (reference: LocalMatrix::RCMK)."""
    return _perm_of_order(_rcm_order(A))


def permute_csr(A: CSR, perm: np.ndarray, device=None) -> CSR:
    """Symmetric permutation B = P A P^T: row/col i of A becomes row/col
    perm[i] of B (reference: LocalMatrix::Permute), on ``device`` (default:
    A's)."""
    data, indices, _ = _host_csr(A)
    rows = get_host(A, "row_ids").astype(np.int64)
    perm = np.asarray(perm, dtype=np.int64)
    return CSR.from_coo(perm[rows], perm[indices], data, A.shape,
                        device=A.device if device is None else device)


def permute_rows_csr(A: CSR, perm: np.ndarray, device=None) -> CSR:
    """Row-only permutation (for non-symmetric reorders), on ``device``
    (default: A's)."""
    data, indices, _ = _host_csr(A)
    rows = get_host(A, "row_ids").astype(np.int64)
    perm = np.asarray(perm, dtype=np.int64)
    return CSR.from_coo(perm[rows], indices, data, A.shape,
                        device=A.device if device is None else device)
