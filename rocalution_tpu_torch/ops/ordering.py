"""Matrix reorderings: Cuthill-McKee and the symmetric permutation.

Counterpart of rocalution_tpu/ops/ordering.py (reference: LocalMatrix::
CMK, RCMK and Permute, local_matrix.hpp:434-496). Orderings are setup work
on the host: they read the CSR's host arrays and return numpy
permutations; `permute_csr` builds the permuted CSR on the host and sends
it to its device once. The module's other orderings (multicoloring, MIS,
connectivity order) come with the preconditioners that use them
(ROADMAP.md section 1 item 8).
"""

from __future__ import annotations

import numpy as np

from ..formats import CSR
from ..formats.base import get_host


def _host_csr(A: CSR):
    data = get_host(A, "data")
    indices = get_host(A, "indices").astype(np.int64)
    indptr = get_host(A, "indptr").astype(np.int64)
    return data, indices, indptr


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
