"""Structure and value validators (reference: the DEBUG_MODE Check(),
local_matrix.hpp:99-106, run at every op entry when the debug flag is
set).

Counterpart of rocalution_tpu/utils/validate.py: host-side checks on the
numpy caches (setup phase), the same errors on the same inputs. With
`set_debug(True)` a solver runs `check_matrix` and `check_vector` on its
operands when it starts (solvers/krylov/_common.py:prepare).
"""

from __future__ import annotations

import numpy as np
import torch

from ..formats import CSR, to_csr
from ..formats.base import get_host


class ValidationError(ValueError):
    pass


def check_matrix(A, name: str = "matrix") -> None:
    """Structural and numeric sanity of a matrix (host-side)."""
    csr = A if isinstance(A, CSR) else to_csr(A)
    indptr = get_host(csr, "indptr").astype(np.int64)
    indices = get_host(csr, "indices").astype(np.int64)
    data = get_host(csr, "data")
    n, m = csr.shape
    if len(indptr) != n + 1:
        raise ValidationError(f"{name}: indptr length {len(indptr)} != n+1")
    if indptr[0] != 0 or indptr[-1] != len(indices):
        raise ValidationError(f"{name}: indptr endpoints invalid")
    if np.any(np.diff(indptr) < 0):
        raise ValidationError(f"{name}: indptr not monotone")
    if len(indices) and (indices.min() < 0 or indices.max() >= m):
        raise ValidationError(f"{name}: column index out of range")
    if not np.all(np.isfinite(data)):
        raise ValidationError(f"{name}: non-finite values present")


def check_vector(v, name: str = "vector") -> None:
    arr = v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    if not np.all(np.isfinite(arr)):
        raise ValidationError(f"{name}: non-finite values present")


def assert_spd_sample(A, k: int = 4, seed: int = 0, tol: float = 0.0):
    """Cheap SPD probe: k random Rayleigh quotients must be positive
    (a debug aid for preconditioners that need SPD). The probes are numpy
    `default_rng(seed)` draws, the JAX package's."""
    from ..ops.spmv import spmv

    rng = np.random.default_rng(seed)
    n = A.shape[0]
    for _ in range(k):
        x = rng.standard_normal(n)
        xt = torch.from_numpy(x).to(device=A.device, dtype=A.dtype)
        q = float(x @ spmv(A, xt).cpu().numpy().astype(np.float64))
        if q <= tol:
            raise ValidationError(f"matrix is not SPD (x'Ax = {q})")
