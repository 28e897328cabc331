"""PMIS aggregation and PMIS C/F splitting on the device.

Counterpart of rocalution_tpu/solvers/multigrid/aggregation_device.py
(reference: the PMIS setup kernels that run on the GPU,
src/base/hip/hip_rsamg_csr.cpp, hip_kernels_rsamg_csr.hpp: random-hash
Luby rounds, strong-influence and coarse-edge passes). Every step is a
segment max over the strength graph's edge list (`scatter_reduce_` with
"amax"); the JAX package's `lax.while_loop`s become Python loops of torch
ops on the device, each round ending in one host read of its "go on"
flag. The keys are the JAX package's, drawn from numpy's
``default_rng(seed)`` (int32 priorities for aggregation, int64
"dependents * n + priority" keys for C/F splitting), so both packages and
both devices give the same aggregates and C/F maps.

The distance-2 Luby test of aggregation, max over k in N2(i) \\ {i} of
w_k < w_i, runs as two rounds of edge segment max:
    m1(j) = max over k in N(j) of key(k)
    m2(i) = max over j in N(i) of max(key(j), m1(j))
m2 includes w_i through the path i -> j -> i, so with unique keys the
PMIS condition is key(i) >= m2(i) (an isolated node has m2 = the dtype's
minimum and is selected): no distance-2 pattern is built.
"""

from __future__ import annotations

import numpy as np
import torch

from ...config import resolve_device


def _seg_max(vals, rows, n):
    """Per-segment max of vals by segment id `rows`; an empty segment
    holds the dtype's minimum (jax.ops.segment_max's identity)."""
    out = torch.full((n,), torch.iinfo(vals.dtype).min, dtype=vals.dtype,
                     device=vals.device)
    return out.scatter_reduce_(0, rows, vals, reduce="amax",
                               include_self=True)


def _edges(indptr, indices, n, device):
    """(rows, cols) of a CSR pattern's edges as int64 tensors on device."""
    rows = np.repeat(np.arange(n, dtype=np.int64),
                     np.diff(np.asarray(indptr, np.int64)))
    return (torch.from_numpy(rows).to(device),
            torch.from_numpy(np.asarray(indices, np.int64)).to(device))


def pmis_aggregate_device(indptr, indices, n: int, w,
                          device=None) -> torch.Tensor:
    """PMIS aggregation on ``device`` (default: the default device).
    `indptr`/`indices`: the (symmetric) strength graph in CSR; `w`: unique
    integer keys (a permutation). Returns the aggregate ids (n,) int32,
    leftovers as singletons (aggregation.pmis_aggregate's contract)."""
    dev = resolve_device(device)
    rows, cols = _edges(indptr, indices, n, dev)
    # int32 keys: float32 cannot hold unique keys past 2^24 nodes
    w = torch.as_tensor(np.asarray(w), dtype=torch.int32).to(dev)
    minus_one = torch.tensor(-1, dtype=torch.int32, device=dev)
    candidate = torch.ones(n, dtype=torch.bool, device=dev)
    is_root = torch.zeros(n, dtype=torch.bool, device=dev)
    while bool(candidate.any()):
        key = torch.where(candidate, w, minus_one)
        m1 = _seg_max(key[cols], rows, n)
        km = torch.maximum(key, m1)
        m2 = _seg_max(km[cols], rows, n)
        sel = candidate & (key >= m2)
        is_root |= sel
        # knock out the selected roots' distance-<=2 neighbourhood
        s1 = _seg_max(sel[cols].to(torch.int32), rows, n) > 0
        s12 = sel | s1
        s2 = _seg_max(s12[cols].to(torch.int32), rows, n) > 0
        candidate &= ~(s12 | s2)
    root_id = torch.cumsum(is_root.to(torch.int32), 0, dtype=torch.int32) - 1
    agg = torch.where(is_root, root_id, minus_one)
    # neighbours join adjacent aggregates (round 1: the roots' neighbours,
    # further rounds: leftovers; the reference's coarse-edge passes)
    for _ in range(4):
        nbr = _seg_max(agg[cols], rows, n)
        agg = torch.where((agg < 0) & (nbr >= 0), nbr, agg)
    # the remaining isolates become singleton aggregates
    na = agg.max() + 1
    left = agg < 0
    extra = torch.cumsum(left.to(torch.int32), 0, dtype=torch.int32) - 1
    return torch.where(left, na + extra, agg).to(torch.int32)


def pmis_coarsening_device(Sgraph, seed: int = 0, device=None) -> np.ndarray:
    """RS PMIS C/F splitting on ``device`` (default: the default device;
    reference: RSPMISCoarsening, hip_rsamg_csr.cpp — random-hash Luby
    rounds, then dependents become F). Distance-1 Luby over the
    symmetrized strength graph, F-marking by a segment max over the
    transpose's edge list. Returns cfmap (True = C), rs.pmis_coarsening's
    contract."""
    n = Sgraph.shape[0]
    dev = resolve_device(device)
    ST = Sgraph.T.tocsr()
    G = ((Sgraph + ST) > 0).astype(np.int8).tocsr()
    G.sort_indices()
    rng = np.random.default_rng(seed)
    # weight = #dependents * n + random tiebreak, one unique int64 key
    lam = np.diff(ST.indptr).astype(np.int64)
    w = torch.from_numpy(lam * n + rng.permutation(n)).to(dev)
    g_rows, g_cols = _edges(G.indptr, G.indices, n, dev)
    st_rows, st_cols = _edges(ST.indptr, ST.indices, n, dev)
    iso = torch.from_numpy(np.diff(G.indptr) == 0).to(dev)
    one, two = (torch.tensor(v, dtype=torch.int8, device=dev)
                for v in (1, 2))
    minus_one = torch.tensor(-1, dtype=torch.int64, device=dev)
    # 0 undecided, 1 C, 2 F
    cf = torch.where(iso, one, torch.zeros((), dtype=torch.int8,
                                           device=dev))
    progress = torch.tensor(True, device=dev)
    while bool((cf == 0).any() & progress):
        und = cf == 0
        key = torch.where(und, w, minus_one)
        m1 = _seg_max(key[g_cols], g_rows, n)
        sel = und & (key > m1)
        cf = torch.where(sel, one, cf)
        # undecided points depending on a new C point become F
        hit = _seg_max(sel[st_rows].to(torch.int32), st_cols, n) > 0
        cf = torch.where((cf == 0) & hit, two, cf)
        progress = sel.any()
    cf = torch.where(cf == 0, one, cf)      # stall safety: the rest -> C
    return cf.cpu().numpy() == 1


def pmis_aggregate_jit(C, seed: int = 0, device=None) -> np.ndarray:
    """aggregation.pmis_aggregate's signature over the device loop: takes
    a scipy strength graph, returns numpy aggregate ids numbered by first
    row."""
    from .aggregation import _relabel_by_first_row

    n = C.shape[0]
    if n == 0 or C.nnz == 0:
        return np.arange(n, dtype=np.int64)
    w = np.random.default_rng(seed).permutation(n)
    Cs = C.tocsr()
    Cs.sort_indices()
    agg = pmis_aggregate_device(Cs.indptr, Cs.indices, n, w, device)
    # row-order coarse numbering keeps P/R/Ac banded (see aggregation.py)
    return _relabel_by_first_row(agg.cpu().numpy().astype(np.int64))
