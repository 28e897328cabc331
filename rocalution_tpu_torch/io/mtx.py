"""MatrixMarket IO.

Counterpart of rocalution_tpu/io/mtx.py (reference: read_matrix_mtx /
write_matrix_mtx, src/base/host/host_io.cpp: banner parsing, symmetric
expansion). The body of a coordinate file is parsed by the native layer's
`mtx_body` where it is built, else by numpy.
"""

from __future__ import annotations

import numpy as np

from ..formats import CSR


def read_mtx(path: str, dtype=np.float64, device=None) -> CSR:
    """Read a MatrixMarket coordinate file into CSR on ``device``.

    Real, integer, pattern and complex fields; general, symmetric,
    skew-symmetric and Hermitian symmetry (the mirrored entries are added,
    as the reference's reader does). A complex file gives a complex128
    CSR."""
    with open(path, "r") as f:
        header = f.readline()
        if not header.startswith("%%MatrixMarket"):
            raise ValueError(f"{path}: not a MatrixMarket file")
        parts = header.strip().split()
        if len(parts) < 5 or parts[1] != "matrix" or parts[2] != "coordinate":
            raise ValueError(
                f"{path}: unsupported MatrixMarket banner: {header!r}")
        field, symmetry = parts[3], parts[4]
        if field == "complex":
            dtype = np.complex128
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        nrow, ncol, nnz = (int(t) for t in line.split())
        body_offset = f.tell()
        from .. import native

        ncl = 2 if field == "pattern" else (4 if field == "complex" else 3)
        if native.available() and nnz > 0:
            rows, cols, re_v, im_v = native.mtx_body(path, body_offset, nnz,
                                                     ncl)
        else:
            body = np.loadtxt(f, ndmin=2) if nnz > 0 else np.zeros((0, 3))
            if body.shape[0] != nnz:
                raise ValueError(
                    f"{path}: expected {nnz} entries, got {body.shape[0]}")
            rows = body[:, 0].astype(np.int64) - 1
            cols = body[:, 1].astype(np.int64) - 1
            re_v = body[:, 2] if body.shape[1] > 2 else None
            im_v = body[:, 3] if body.shape[1] > 3 else None
    if field == "pattern":
        vals = np.ones(nnz, dtype=dtype)
    elif field == "complex":
        vals = re_v + 1j * im_v
    else:
        vals = np.asarray(re_v, dtype=dtype)
    if symmetry in ("symmetric", "hermitian", "skew-symmetric"):
        off = rows != cols
        extra_v = vals[off]
        if symmetry == "skew-symmetric":
            extra_v = -extra_v
        elif symmetry == "hermitian":
            extra_v = np.conj(extra_v)
        rows, cols = (np.concatenate([rows, cols[off]]),
                      np.concatenate([cols, rows[off]]))
        vals = np.concatenate([vals, extra_v])
    return CSR.from_coo(rows, cols, vals, (nrow, ncol), device=device)


def write_mtx(path: str, mat) -> None:
    """Write a CSR (or a format `to_csr` converts) as a general real
    MatrixMarket file, one line an entry, values to 17 significant
    digits (the JAX package's bytes)."""
    from ..formats import to_csr

    csr = to_csr(mat)
    data, indices, _ = csr.numpy_triplet()
    rows = csr.numpy_rows()
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write(f"{csr.shape[0]} {csr.shape[1]} {len(data)}\n")
        for r, c, v in zip(rows, indices, data):
            f.write(f"{r + 1} {c + 1} {v:.17g}\n")


def read_mtx_vector(path: str, dtype=np.float64) -> np.ndarray:
    """Read a MatrixMarket array file as a host vector."""
    with open(path, "r") as f:
        f.readline()
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        body = np.loadtxt(f)
    return body.astype(dtype).reshape(-1)
