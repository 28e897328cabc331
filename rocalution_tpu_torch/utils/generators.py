"""Test-problem generators.

Counterpart of rocalution_tpu/utils/generators.py, copied line for line so
the host triplets are bit-identical (reference: `gen_2d_laplacian`,
clients/include/utility.hpp:46); `fem_2d_unstructured` draws its points
from numpy's default_rng(seed) and triangulates with scipy, as the JAX
package does. Built host-side with numpy; ``device``
says where the CSR's tensors go (default: the configured device).
"""

from __future__ import annotations

import numpy as np

from ..config import numpy_dtype, resolve_device
from ..formats import CSR


def laplacian_2d(n: int, dtype=None, device=None) -> CSR:
    """5-point 2D Laplacian on an n x n grid (Dirichlet), N = n^2 unknowns."""
    dtype = numpy_dtype(dtype)
    N = n * n
    idx = np.arange(N, dtype=np.int64)
    ix = idx % n
    iy = idx // n
    rows, cols, vals = [], [], []

    def add(mask, r, c, v):
        rows.append(r[mask])
        cols.append(c[mask])
        vals.append(np.full(mask.sum(), v, dtype=dtype))

    add(np.ones(N, dtype=bool), idx, idx, 4.0)
    add(ix > 0, idx, idx - 1, -1.0)
    add(ix < n - 1, idx, idx + 1, -1.0)
    add(iy > 0, idx, idx - n, -1.0)
    add(iy < n - 1, idx, idx + n, -1.0)
    return CSR.from_coo(
        np.concatenate(rows), np.concatenate(cols), np.concatenate(vals),
        (N, N), device=device,
    )


def laplacian_2d_block(n: int, row_lo: int, row_hi: int, dtype=None):
    """Rows [row_lo, row_hi) of the 5-point 2D Laplacian as a COO block
    (local_rows, global_cols, values) of host arrays: each rank's patch
    built without the global matrix (reference: clients/samples/
    laplace_2d_weak_scaling.cpp)."""
    dtype = numpy_dtype(dtype)
    idx = np.arange(row_lo, row_hi, dtype=np.int64)
    ix = idx % n
    iy = idx // n
    rows, cols, vals = [], [], []

    def add(mask, r, c, v):
        rows.append(r[mask] - row_lo)
        cols.append(c[mask])
        vals.append(np.full(mask.sum(), v, dtype=dtype))

    add(np.ones(len(idx), dtype=bool), idx, idx, 4.0)
    add(ix > 0, idx, idx - 1, -1.0)
    add(ix < n - 1, idx, idx + 1, -1.0)
    add(iy > 0, idx, idx - n, -1.0)
    add(iy < n - 1, idx, idx + n, -1.0)
    return (np.concatenate(rows), np.concatenate(cols),
            np.concatenate(vals))


def laplacian_3d_block(n: int, row_lo: int, row_hi: int, dtype=None):
    """Rows [row_lo, row_hi) of the 7-point 3D Laplacian as a COO block
    (local_rows, global_cols, values) of host arrays (reference: the
    laplace_3d weak-scaling generator, clients/samples)."""
    dtype = numpy_dtype(dtype)
    idx = np.arange(row_lo, row_hi, dtype=np.int64)
    ix = idx % n
    iy = (idx // n) % n
    iz = idx // (n * n)
    rows, cols, vals = [], [], []

    def add(mask, r, c, v):
        rows.append(r[mask] - row_lo)
        cols.append(c[mask])
        vals.append(np.full(mask.sum(), v, dtype=dtype))

    add(np.ones(len(idx), dtype=bool), idx, idx, 6.0)
    add(ix > 0, idx, idx - 1, -1.0)
    add(ix < n - 1, idx, idx + 1, -1.0)
    add(iy > 0, idx, idx - n, -1.0)
    add(iy < n - 1, idx, idx + n, -1.0)
    add(iz > 0, idx, idx - n * n, -1.0)
    add(iz < n - 1, idx, idx + n * n, -1.0)
    return (np.concatenate(rows), np.concatenate(cols),
            np.concatenate(vals))


def anisotropic_laplacian_2d(n: int, epsilon: float = 0.1, dtype=None,
                             device=None) -> CSR:
    """Anisotropic 5-point Laplacian, -u_xx - eps*u_yy on an n x n grid:
    the classic AMG stress problem (smooth error aligns with the strong
    direction)."""
    dtype = numpy_dtype(dtype)
    N = n * n
    idx = np.arange(N, dtype=np.int64)
    ix = idx % n
    iy = idx // n
    rows, cols, vals = [], [], []

    def add(mask, r, c, v):
        rows.append(r[mask])
        cols.append(c[mask])
        vals.append(np.full(mask.sum(), v, dtype=dtype))

    add(np.ones(N, dtype=bool), idx, idx, 2.0 + 2.0 * epsilon)
    add(ix > 0, idx, idx - 1, -1.0)
    add(ix < n - 1, idx, idx + 1, -1.0)
    add(iy > 0, idx, idx - n, -epsilon)
    add(iy < n - 1, idx, idx + n, -epsilon)
    return CSR.from_coo(
        np.concatenate(rows), np.concatenate(cols), np.concatenate(vals),
        (N, N), device=device,
    )


def laplacian_3d(n: int, dtype=None, device=None) -> CSR:
    """7-point 3D Laplacian on an n^3 grid (Dirichlet)."""
    dtype = numpy_dtype(dtype)
    N = n * n * n
    idx = np.arange(N, dtype=np.int64)
    ix = idx % n
    iy = (idx // n) % n
    iz = idx // (n * n)
    rows, cols, vals = [], [], []

    def add(mask, r, c, v):
        rows.append(r[mask])
        cols.append(c[mask])
        vals.append(np.full(mask.sum(), v, dtype=dtype))

    add(np.ones(N, dtype=bool), idx, idx, 6.0)
    add(ix > 0, idx, idx - 1, -1.0)
    add(ix < n - 1, idx, idx + 1, -1.0)
    add(iy > 0, idx, idx - n, -1.0)
    add(iy < n - 1, idx, idx + n, -1.0)
    add(iz > 0, idx, idx - n * n, -1.0)
    add(iz < n - 1, idx, idx + n * n, -1.0)
    return CSR.from_coo(
        np.concatenate(rows), np.concatenate(cols), np.concatenate(vals),
        (N, N), device=device,
    )


def convection_diffusion_2d(n: int, peclet: float = 20.0, dtype=None,
                            device=None) -> CSR:
    """Nonsymmetric 2D convection-diffusion operator (5-point diffusion +
    first-order upwind convection, Dirichlet), N = n^2 unknowns: the
    nonsymmetric target of the GMRES/ILU rows (reference: the same
    GMRES/ILU stack, clients/samples/gmres.cpp)."""
    dtype = numpy_dtype(dtype)
    N = n * n
    h = 1.0 / (n + 1)
    bx, by = peclet, 0.5 * peclet          # constant convection field
    idx = np.arange(N, dtype=np.int64)
    ix = idx % n
    iy = idx // n
    rows, cols, vals = [], [], []

    def add(mask, r, c, v):
        rows.append(r[mask])
        cols.append(c[mask])
        vals.append(np.full(mask.sum(), v, dtype=dtype))

    diag = 4.0 + h * (abs(bx) + abs(by))
    add(np.ones(N, dtype=bool), idx, idx, diag)
    add(ix > 0, idx, idx - 1, -1.0 - h * max(bx, 0.0))
    add(ix < n - 1, idx, idx + 1, -1.0 + h * min(bx, 0.0))
    add(iy > 0, idx, idx - n, -1.0 - h * max(by, 0.0))
    add(iy < n - 1, idx, idx + n, -1.0 + h * min(by, 0.0))
    return CSR.from_coo(
        np.concatenate(rows), np.concatenate(cols), np.concatenate(vals),
        (N, N), device=device,
    )


def random_banded_spd(n: int, nnz_per_row: int = 7, bandwidth: int = 8192,
                      seed: int = 0, dtype=None, device=None) -> CSR:
    """Random SPD matrix with scattered columns inside a band — the stand-in
    for an RCM-reordered SuiteSparse matrix (unstructured sparsity, bounded
    bandwidth). Diagonally dominant."""
    dtype = numpy_dtype(dtype)
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), nnz_per_row)
    d = rng.integers(-bandwidth, bandwidth + 1, size=rows.shape[0])
    cols = np.clip(rows + d, 0, n - 1)
    vals = rng.standard_normal(rows.shape[0]).astype(dtype)
    r = np.concatenate([rows, cols])
    c = np.concatenate([cols, rows])
    v = np.concatenate([vals, vals])
    dom = np.zeros(n, dtype=np.float64)
    np.add.at(dom, r, np.abs(v).astype(np.float64))
    r = np.concatenate([r, np.arange(n)])
    c = np.concatenate([c, np.arange(n)])
    v = np.concatenate([v, (dom + 1.0).astype(dtype)])
    return CSR.from_coo(r, c, v, (n, n), device=device)


def permuted_identity(n: int, seed: int = 0, dtype=None, device=None) -> CSR:
    """Random permutation matrix (reference bench matrix_init
    'permuted_identity', clients/benchmarks/
    rocalution_enum_matrix_init.hpp:33-36)."""
    dtype = numpy_dtype(dtype)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    return CSR.from_coo(np.arange(n), perm, np.ones(n, dtype=dtype), (n, n),
                        device=device)


def random_spd(n: int, density: float = 0.05, seed: int = 0, dtype=None,
               device=None) -> CSR:
    """Random diagonally dominant SPD matrix for solver tests."""
    dtype = numpy_dtype(dtype)
    rng = np.random.default_rng(seed)
    nnz = max(1, int(n * n * density / 2))
    r = rng.integers(0, n, nnz)
    c = rng.integers(0, n, nnz)
    keep = r != c
    r, c = r[keep], c[keep]
    v = rng.standard_normal(len(r)).astype(dtype)
    rows = np.concatenate([r, c])
    cols = np.concatenate([c, r])
    vals = np.concatenate([v, v])  # symmetric
    # diagonal dominance
    dom = np.zeros(n, dtype=dtype)
    np.add.at(dom, rows, np.abs(vals))
    rows = np.concatenate([rows, np.arange(n)])
    cols = np.concatenate([cols, np.arange(n)])
    vals = np.concatenate([vals, dom + 1.0])
    return CSR.from_coo(rows, cols, vals, (n, n), device=device)


def fem_2d_unstructured(npts: int, seed: int = 0, dtype=None,
                        rcm: bool = True, parabolic: bool = False,
                        dt: float = None, device=None) -> CSR:
    """P1 finite-element stiffness matrix on a random Delaunay
    triangulation of the unit square: an unstructured operator (variable
    row degree, irregular sparsity; the bcsstk / parabolic_fem class). SPD
    through a lumped mass shift (pure Neumann stiffness has the constant
    nullspace); ``parabolic=True`` builds M + dt*K, the implicit-Euler heat
    operator. ``rcm``: reverse Cuthill-McKee reordering (ops/ordering),
    without which a random point cloud has bandwidth ~n. The host arrays
    are built on the host in full, then the CSR goes to ``device``."""
    from scipy.spatial import Delaunay

    dtype = numpy_dtype(dtype)
    rng = np.random.default_rng(seed)
    pts = rng.random((npts, 2))
    tri = Delaunay(pts).simplices                       # (nt, 3)
    p0, p1, p2 = pts[tri[:, 0]], pts[tri[:, 1]], pts[tri[:, 2]]
    # edge vectors opposite each vertex; grad phi_i = rot90(e_i)/(2A)
    e0 = p2 - p1
    e1 = p0 - p2
    e2 = p1 - p0
    area2 = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]   # 2*signed area
    area = np.abs(area2) / 2.0
    g = np.stack([e0, e1, e2], axis=1)                  # (nt, 3, 2)
    g = np.stack([-g[..., 1], g[..., 0]], axis=-1)      # rotate 90 degrees
    g /= area2[:, None, None]
    # element stiffness K_ij = area * g_i . g_j  (nt, 3, 3)
    Ke = area[:, None, None] * np.einsum("tid,tjd->tij", g, g)
    rows = np.repeat(tri, 3, axis=1).reshape(-1)        # i index
    cols = np.tile(tri, (1, 3)).reshape(-1)             # j index
    vals = Ke.reshape(-1)
    if parabolic:
        if dt is None:
            dt = 2.0 / npts         # ~2x the mean element area
        vals = vals * dt
    # lumped mass: area/3 per vertex per element
    mr = tri.reshape(-1)
    mv = np.repeat(area / 3.0, 3)
    rows = np.concatenate([rows, mr])
    cols = np.concatenate([cols, mr])
    vals = np.concatenate([vals, mv])
    device = resolve_device(device)
    A = CSR.from_coo(rows, cols, vals.astype(dtype), (npts, npts),
                     device="cpu" if rcm else device)
    if rcm:
        from ..ops.ordering import permute_csr, rcmk

        A = permute_csr(A, rcmk(A), device=device)
    return A
