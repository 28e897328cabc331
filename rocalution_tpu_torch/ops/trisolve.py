"""Triangular solves: level-scheduled and iterative (Jacobi sweeps).

Counterpart of rocalution_tpu/ops/trisolve.py (reference:
LocalMatrix::{L,U,LL,LU}Solve with LAnalyse/UAnalyse, the level-scheduling
analysis of base_matrix.hpp:343-351, and the iterative variants
ItLSolve/ItUSolve/csritsv).

* The analysis (`build_schedule`) is the JAX package's host code as is: a
  vectorized Kahn layering of the row-dependency DAG into a padded
  `LevelSchedule`, whose arrays go to the device once.
* `solve_schedule` is a loop over levels of plain torch ops on that device
  (gather, multiply, `index_add_`, scatter): the reference's is a
  `lax.scan`, XLA code and no Pallas kernel, so the port writes no kernel
  for it.
* `trisolve_jacobi` runs fixed Jacobi-Richardson sweeps on the factor: its
  off-diagonal part (`prepare_offd`, built once at setup) is a CSR on the
  device, which on the card carries a WJD plan, so every sweep is a WJD
  kernel launch. The inverse diagonal is folded from the host arrays once
  (`inverse_diagonal_of`), as the reference folds it at trace time.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import resolve_device
from ..formats import CSR
from ..formats.base import get_host, to_device


class LevelSchedule(NamedTuple):
    """Padded level structure for solving T x = b where T is triangular.

    All arrays are stacked per level (axis 0 = level):
      rows      (nlev, W)  row solved in each level slot; pad = n
      nz_slot   (nlev, NW) level-local slot of each off-diag nonzero; pad = W
      nz_col    (nlev, NW) column of each off-diag nonzero; pad = n
      nz_val    (nlev, NW) value of each off-diag nonzero; pad = 0
      inv_diag  (nlev, W)  1/diagonal of each row; pad = 0
    """

    rows: torch.Tensor
    nz_slot: torch.Tensor
    nz_col: torch.Tensor
    nz_val: torch.Tensor
    inv_diag: torch.Tensor

    @property
    def nlev(self) -> int:
        return int(self.rows.shape[0])


def build_schedule(T: CSR, unit_diag: bool = False,
                   device=None) -> LevelSchedule:
    """Analyse a triangular CSR matrix into a LevelSchedule on ``device``
    (default: T's): host-side, vectorized Kahn layering (analog
    LocalMatrix::LAnalyse/UAnalyse)."""
    import scipy.sparse as sp

    data = get_host(T, "data")
    cols = get_host(T, "indices").astype(np.int64)
    rows = get_host(T, "row_ids").astype(np.int64)
    n = T.shape[0]

    off = cols != rows
    is_diag = ~off
    diag = np.ones(n, dtype=data.dtype)
    if not unit_diag:
        diag_vals = np.zeros(n, dtype=data.dtype)
        np.add.at(diag_vals, rows[is_diag], data[is_diag])
        if np.any(diag_vals == 0):
            raise ValueError("triangular matrix has zero diagonal")
        diag = diag_vals
    inv_diag_full = 1.0 / diag

    orow, ocol, oval = rows[off], cols[off], data[off]
    # Kahn layering on the dependency DAG row <- col
    ndeps = np.zeros(n, dtype=np.int64)
    np.add.at(ndeps, orow, 1)
    # reverse adjacency: for node j, which rows depend on it
    radj = sp.csr_matrix(
        (np.ones(len(orow), np.int8), (ocol, orow)), shape=(n, n)
    )
    level = np.full(n, -1, dtype=np.int64)
    frontier = np.where(ndeps == 0)[0]
    lev = 0
    while len(frontier):
        level[frontier] = lev
        dep_rows = radj[frontier].indices
        if len(dep_rows):
            np.subtract.at(ndeps, dep_rows, 1)
        ndeps[frontier] = -1
        frontier = np.where(ndeps == 0)[0]
        lev += 1
    if (level < 0).any():
        raise ValueError("matrix is not triangular (dependency cycle)")
    nlev = lev

    order = np.argsort(level, kind="stable")
    lvl_sizes = np.bincount(level, minlength=nlev)
    W = int(lvl_sizes.max()) if nlev else 0
    starts = np.concatenate([[0], np.cumsum(lvl_sizes)])

    rows_pad = np.full((nlev, W), n, dtype=np.int32)
    invd_pad = np.zeros((nlev, W), dtype=data.dtype)
    slot_of_row = np.zeros(n, dtype=np.int64)
    lev_sorted = level[order]
    slot_sorted = np.arange(n) - starts[lev_sorted]
    rows_pad[lev_sorted, slot_sorted] = order
    invd_pad[lev_sorted, slot_sorted] = inv_diag_full[order]
    slot_of_row[order] = slot_sorted

    # off-diagonal nonzeros grouped by level of their row
    nz_lev = level[orow]
    nz_order = np.argsort(nz_lev, kind="stable")
    nz_sizes = np.bincount(nz_lev, minlength=nlev)
    NW = max(int(nz_sizes.max()) if nlev else 0, 1)
    nz_starts = np.concatenate([[0], np.cumsum(nz_sizes)])
    slot_pad = np.full((nlev, NW), W, dtype=np.int32)
    col_pad = np.full((nlev, NW), n, dtype=np.int32)
    val_pad = np.zeros((nlev, NW), dtype=data.dtype)
    nzlev_sorted = nz_lev[nz_order]
    nzslot_sorted = np.arange(len(nz_order)) - nz_starts[nzlev_sorted]
    slot_pad[nzlev_sorted, nzslot_sorted] = slot_of_row[orow[nz_order]]
    col_pad[nzlev_sorted, nzslot_sorted] = ocol[nz_order]
    val_pad[nzlev_sorted, nzslot_sorted] = oval[nz_order]

    dev = T.device if device is None else resolve_device(device)
    return LevelSchedule(
        rows=to_device(rows_pad, dev),
        nz_slot=to_device(slot_pad, dev),
        nz_col=to_device(col_pad, dev),
        nz_val=to_device(val_pad, dev),
        inv_diag=to_device(invd_pad, dev),
    )


def solve_schedule(sched: LevelSchedule, b):
    """Solve T x = b given the analysis: one step of plain torch ops per
    level, on the schedule's device, for b of shape (n,) or (n, k)."""
    n = b.shape[0]
    W = sched.rows.shape[1]
    tail = tuple(b.shape[1:])
    x = b.new_zeros((n + 1,) + tail)
    # every level's right-hand side, gathered once (row n is the pad's 0)
    b_lev = torch.cat([b, b.new_zeros((1,) + tail)])[sched.rows.long()]
    rows, nz_slot, nz_col = (sched.rows.long(), sched.nz_slot.long(),
                             sched.nz_col.long())
    nz_val, invd = sched.nz_val, sched.inv_diag
    if tail:
        nz_val, invd = nz_val[..., None], invd[..., None]
    for lev in range(sched.nlev):
        prod = x[nz_col[lev]] * nz_val[lev]
        s = x.new_zeros((W + 1,) + tail).index_add_(0, nz_slot[lev], prod)
        x[rows[lev]] = (b_lev[lev] - s[:W]) * invd[lev]
    return x[:n]


def _host_diagonal(T: CSR) -> np.ndarray:
    dh = get_host(T, "data")
    ih = get_host(T, "indices")
    rh = get_host(T, "row_ids")
    sel = ih == rh
    dv = np.zeros(T.shape[0], dh.dtype)
    dv[rh[sel]] = dh[sel]
    return dv


def inverse_diagonal_of(T: CSR, device, dtype) -> torch.Tensor:
    """1/diag(T) on ``device`` in ``dtype`` (zero diagonal entries map to
    1), folded once from T's host arrays and kept on T for later sweeps."""
    key = (torch.device(device), dtype)
    cache = getattr(T, "_invd_cache", None)
    if cache is None:
        cache = {}
        object.__setattr__(T, "_invd_cache", cache)
    if key not in cache:
        dv = _host_diagonal(T)
        inv = np.where(dv != 0, 1.0 / np.where(dv == 0, 1.0, dv), 1.0)
        cache[key] = torch.from_numpy(inv).to(device=key[0], dtype=dtype)
    return cache[key]


def prepare_offd(T: CSR, device=None) -> CSR:
    """Build + cache the off-diagonal part of a host-built factor on
    ``device`` (default: T's), with its WJD plan attached where auto-attach
    holds (on the card): the csritsv analysis stage, run once at
    preconditioner build. The off-diagonal part keeps T's pattern (its
    diagonal as explicit zeros), as the reference's does. A plan that fails
    raises: unlike the JAX package, which keeps its plain apply for a
    factor too scattered for its kernel, the port has no quiet way around
    the kernel."""
    from .spmv import _wjd_eligible, attach_wjd, auto_wjd_applies

    dev = T.device if device is None else resolve_device(device)
    N = getattr(T, "_offd_cache", None)
    if N is not None and N.device == dev:
        return N
    dh, ih, ph = T.numpy_triplet()
    rh = T.numpy_rows()
    N = CSR.from_arrays(np.where(rh != ih, dh, 0), ih, ph, T.shape,
                        device=dev)
    if auto_wjd_applies(N) and _wjd_eligible(N):
        attach_wjd(N)
    object.__setattr__(T, "_offd_cache", N)
    return N


def trisolve_jacobi(T: CSR, b, *, sweeps: int = 8, unit_diag: bool = False):
    """Approximate triangular solve by fixed Jacobi-Richardson sweeps
    (reference: ItLSolve/ItUSolve/csritsv semantics):
    x_{k+1} = D^{-1}(b - N x_k) with N the off-diagonal part; exact after
    `nlevels` sweeps, good after far fewer for diagonally dominant
    factors."""
    from .spmv import spmv

    if unit_diag:
        inv_d = None
    else:
        inv_d = inverse_diagonal_of(T, b.device, b.dtype)
        if b.dim() != 1:
            inv_d = inv_d[:, None]
    N = prepare_offd(T, b.device)

    def scale(v):
        return v if inv_d is None else inv_d * v

    x = scale(b)
    for _ in range(sweeps):
        x = scale(b - spmv(N, x))
    return x
