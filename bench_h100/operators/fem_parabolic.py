"""P1 finite elements on a random Delaunay mesh of the unit square:
M + dt * K, the implicit-Euler heat operator, reverse Cuthill-McKee
ordered: a synthetic unstructured operator, not a SuiteSparse matrix.

The element arithmetic is the port's `fem_2d_unstructured(...,
parabolic=True)`: lumped mass area/3 a vertex, stiffness area * g_i . g_j.
The ordering is scipy's `reverse_cuthill_mckee`, so this build depends on
numpy and scipy alone.
"""

from __future__ import annotations

import numpy as np


def assemble(npts: int, seed: int, dt: float):
    """Unordered (indptr, indices, data) of M + dt * K, duplicates summed,
    columns ascending."""
    import scipy.sparse as sp
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(seed)
    pts = rng.random((npts, 2))
    tri = Delaunay(pts).simplices                       # (nt, 3)
    p0, p1, p2 = pts[tri[:, 0]], pts[tri[:, 1]], pts[tri[:, 2]]
    # edge vectors opposite each vertex; grad phi_i = rot90(e_i) / (2 area)
    e0 = p2 - p1
    e1 = p0 - p2
    e2 = p1 - p0
    area2 = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]   # 2 * signed area
    area = np.abs(area2) / 2.0
    g = np.stack([e0, e1, e2], axis=1)                  # (nt, 3, 2)
    g = np.stack([-g[..., 1], g[..., 0]], axis=-1)
    g /= area2[:, None, None]
    Ke = area[:, None, None] * np.einsum("tid,tjd->tij", g, g)
    rows = np.repeat(tri, 3, axis=1).reshape(-1)
    cols = np.tile(tri, (1, 3)).reshape(-1)
    vals = Ke.reshape(-1) * dt
    mr = tri.reshape(-1)
    rows = np.concatenate([rows, mr])
    cols = np.concatenate([cols, mr])
    vals = np.concatenate([vals, np.repeat(area / 3.0, 3)])
    A = sp.coo_matrix((vals, (rows, cols)), shape=(npts, npts)).tocsr()
    A.sum_duplicates()
    A.sort_indices()
    return A


def build(config: dict) -> dict:
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    npts = int(config["points"])
    dt = float(config["dt_times_points"]) / npts
    A = assemble(npts, int(config["mesh_seed"]), dt)
    perm = reverse_cuthill_mckee(A, symmetric_mode=True)
    A = A[perm][:, perm]
    A.sort_indices()
    return {"indptr": A.indptr.astype(np.int64),
            "indices": A.indices.astype(np.int32),
            "data": A.data.astype(np.float64), "shape": A.shape}
