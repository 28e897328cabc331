"""Implicit-Euler diffusion operator A = I + tau * L on an n^3 grid.

L is the 7-point Laplacian with Dirichlet boundaries (6 on the diagonal,
-1 to each of the six neighbours), the matrix of rocALUTION's
`rocalution-bench --matrix-init laplacian3d` and of the port's
`laplacian_3d`. Built straight into CSR, rows in grid order and each
row's columns ascending, with no sort: at 256^3 (117M nonzeros) it takes
seconds where a COO build and a sort take tens.
"""

from __future__ import annotations

import numpy as np


def build(config: dict) -> dict:
    n = int(config["grid"])
    tau = float(config["tau"])
    N = n ** 3
    idx = np.arange(N, dtype=np.int32)
    ix = idx % n
    iy = (idx // n) % n
    iz = idx // (n * n)
    # the seven couplings of a row in ascending column order
    offsets = np.array([-n * n, -n, -1, 0, 1, n, n * n], dtype=np.int32)
    weights = np.array([-tau, -tau, -tau, 1.0 + 6.0 * tau, -tau, -tau,
                        -tau], dtype=np.float64)
    keep = np.empty((N, 7), dtype=bool)
    keep[:, 0] = iz > 0
    keep[:, 1] = iy > 0
    keep[:, 2] = ix > 0
    keep[:, 3] = True
    keep[:, 4] = ix < n - 1
    keep[:, 5] = iy < n - 1
    keep[:, 6] = iz < n - 1
    del ix, iy, iz
    indptr = np.zeros(N + 1, dtype=np.int64)
    np.cumsum(keep.sum(axis=1), out=indptr[1:])
    indices = (idx[:, None] + offsets[None, :])[keep]
    data = np.broadcast_to(weights, (N, 7))[keep]
    return {"indptr": indptr, "indices": indices, "data": data,
            "shape": (N, N)}
