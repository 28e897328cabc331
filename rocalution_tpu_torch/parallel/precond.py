"""Distributed BlockJacobi with LOCAL sub-preconditioners.

Counterpart of rocalution_tpu/parallel/precond.py (reference: the MPI
samples precondition global Krylov solvers with
``BlockJacobi<GlobalMatrix, LocalMatrix>`` wrapping a local solver on
each rank's diagonal block: SPAI (fgmres_mpi.cpp), FSAI (idr_mpi.cpp),
ILU (fcg_mpi.cpp), ILUT (qmrcgstab_mpi.cpp);
preconditioner_blockjacobi.hpp:34-45). Each part's diagonal block gets
its local preconditioner built on the host at setup; the per-block
operators are stacked with a leading (P,) axis and applied to every part
with the same program: COO segment sums and fixed Jacobi tri-sweeps,
block-local work with no communication.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

from ..formats import CSR
from ..formats.base import get_host, to_device
from .partition import GlobalCSR


@dataclasses.dataclass(frozen=True)
class ShardPrecond:
    """A preconditioner applied per part. Every tensor of `arrays` carries
    the leading part axis; `kind` and `sweeps` select the apply (the same
    for every part)."""

    arrays: Tuple[Any, ...]
    kind: str          # "spmv1" | "spmv2" | "sweeps"
    sweeps: int = 8

    def shard_apply(self, arrs, r: torch.Tensor) -> torch.Tensor:
        """z = M^{-1} r for (Pl, nl) r; `arrs` = `arrays`, their leading
        axis the same Pl parts."""
        coo = self._coo
        if self.kind == "spmv1":           # SPAI: one local SpMV
            rows, cols, data = arrs
            return coo(rows, cols, data, r)
        if self.kind == "spmv2":           # FSAI: z = G^T (G r)
            gr, gc, gd, tr, tc, td = arrs
            return coo(tr, tc, td, coo(gr, gc, gd, r))
        if self.kind == "sweeps":          # ILU/ILUT: L then U tri-sweeps
            (lr, lc, ld, ur, uc, ud, invd) = arrs
            y = self._sweeps(lr, lc, ld, None, r)
            return self._sweeps(ur, uc, ud, invd, y)
        raise ValueError(f"unknown ShardPrecond kind {self.kind!r}")

    def _coo(self, rows, cols, data, r):
        """Per-part COO product of (Pl, nnz) triplets of local ids with
        (Pl, n) r; the flat indices are made once per operand."""
        Pl, n = r.shape
        cache = self.__dict__.setdefault("_flat", {})
        key = (id(rows), Pl, n)
        if key not in cache:
            q = torch.arange(Pl, device=r.device, dtype=torch.int64)[:, None]
            cache[key] = ((rows.long() + q * n).reshape(-1),
                          (cols.long() + q * n).reshape(-1))
        rf, cf = cache[key]
        out = r.new_zeros(Pl * n)
        out.index_add_(0, rf, data.reshape(-1) * r.reshape(-1)[cf])
        return out.view(Pl, n)

    def _sweeps(self, rows, cols, data, invd, b):
        """x_{k+1} = D^{-1}(b - N x_k), `sweeps` times, N strictly
        triangular (COO); invd=None means a unit diagonal
        (trisolve_jacobi semantics)."""
        def scale(v):
            return v if invd is None else invd * v

        x = scale(b)
        for _ in range(self.sweeps):
            x = scale(b - self._coo(rows, cols, data, x))
        return x

    def operator(self, parts: int):
        """Closure r -> M^{-1} r over flat vectors of `parts` parts."""
        return lambda r: self.shard_apply(
            self.arrays, r.reshape(parts, -1)).reshape(-1)


def _local_blocks(A: GlobalCSR):
    """Per-part diagonal-block CSRs (on the host) recovered from the
    stacked interior arrays. The valid entries are the first
    ``A.int_nnz[p]`` of each part, so stored zeros (an exactly-zero
    diagonal included) keep their place in the ILU0/SPAI pattern; only
    without the counts does a data != 0 mask decide."""
    data = get_host(A, "int_data")
    rows = get_host(A, "int_rows")
    cols = get_host(A, "int_cols")
    nl = A.n_local
    out = []
    for p in range(A.local_parts):
        if A.int_nnz:
            k = A.int_nnz[p]
            rp, cp, dp = rows[p][:k], cols[p][:k], data[p][:k]
        else:
            m = data[p] != 0
            rp, cp, dp = rows[p][m], cols[p][m], data[p][m]
        out.append(CSR.from_coo(rp, cp, dp, (nl, nl), device="cpu"))
    return out


def _stack_coo(mats, device, nnz=None):
    """Stack local CSRs into (P, nnz_max) COO triplets (zero-padded)."""
    trips = []
    for Mk in mats:
        d, c, _ = Mk.numpy_triplet()
        r = Mk.numpy_rows()
        trips.append((r, c, d))
    mx = max(1, max(len(t[0]) for t in trips)) if nnz is None else nnz
    P = len(trips)
    # dtype from the first NON-EMPTY triplet: an empty first block must
    # not upcast the whole stacked preconditioner to f64
    dt = next((t[2].dtype for t in trips if len(t[2])), np.float64)
    R = np.zeros((P, mx), np.int32)
    C = np.zeros((P, mx), np.int32)
    D = np.zeros((P, mx), dt)
    for p, (r, c, d) in enumerate(trips):
        k = len(r)
        R[p, :k], C[p, :k], D[p, :k] = r, c, d
    return tuple(to_device(a, device) for a in (R, C, D))


def block_jacobi_precond(A: GlobalCSR, kind: str = "spai", *,
                         sweeps: int = 8, **kw) -> ShardPrecond:
    """BlockJacobi with a LOCAL sub-preconditioner per diagonal block
    (reference: preconditioner_blockjacobi.hpp, as every preconditioned
    MPI sample uses it), built on the host, applied on A's device.

    kind: "spai" | "fsai" | "ilu0" | "ilut" (the local solvers of
    fgmres_mpi, idr_mpi, fcg_mpi and qmrcgstab_mpi)."""
    blocks = _local_blocks(A)
    dev = A.device
    if kind == "spai":
        from ..precond.ai import spai_matrix

        return ShardPrecond(
            _stack_coo([spai_matrix(B) for B in blocks], dev), "spmv1")
    if kind == "fsai":
        from ..precond.ai import fsai_matrices

        gs, gts = zip(*(fsai_matrices(B, kw.get("q", 1)) for B in blocks))
        return ShardPrecond(_stack_coo(gs, dev) + _stack_coo(gts, dev),
                            "spmv2")
    if kind in ("ilu0", "ilut"):
        from ..ops.extract import extract_lower, extract_upper
        from ..ops.factorize import ilu0, ilut
        from ..precond.jacobi import inverse_diagonal_host

        Ls, Us, invds = [], [], []
        for B in blocks:
            L, U = (ilu0(B) if kind == "ilu0"
                    else ilut(B, kw.get("tol", 1e-3),
                              kw.get("max_fill", 32)))
            invds.append(inverse_diagonal_host(U))
            Ls.append(extract_lower(L, diag=False))   # strict lower (unit)
            Us.append(extract_upper(U, diag=False))   # strict upper
        lr, lc, ld = _stack_coo(Ls, dev)
        ur, uc, ud = _stack_coo(Us, dev)
        invd = to_device(np.stack(invds), dev)
        return ShardPrecond((lr, lc, ld, ur, uc, ud, invd), "sweeps",
                            sweeps=sweeps)
    raise ValueError(f"unknown block preconditioner kind {kind!r}")
