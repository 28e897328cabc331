"""The package's binary sparse-matrix and vector container.

Counterpart of rocalution_tpu/io/binary.py (reference: the rocsparseio
versioned container, src/utils/rocsparseio.{h,hpp,cpp}, behind
LocalMatrix::WriteFileCSR/ReadFileCSR and LocalVector's binary IO): a
self-describing ``.npz`` (magic, version, format tag, index and value
arrays), the same files as the JAX package's, which each package reads.
The per-rank global layout waits for the distributed layer.
"""

from __future__ import annotations

import numpy as np

from ..formats import CSR
from ..formats.base import get_host

MAGIC = "rocalution_tpu_bin"
VERSION = 1


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def write_csr(path: str, A: CSR) -> None:
    """Write a CSR matrix from its host arrays (reference:
    LocalMatrix::WriteFileCSR)."""
    np.savez(
        _npz(path),
        magic=MAGIC, version=VERSION, fmt="csr",
        nrow=A.shape[0], ncol=A.shape[1],
        data=get_host(A, "data"),
        indices=get_host(A, "indices").astype(np.int32),
        indptr=get_host(A, "indptr").astype(np.int64),
    )


def read_csr(path: str, device=None) -> CSR:
    """Read a CSR matrix onto ``device`` (reference:
    LocalMatrix::ReadFileCSR)."""
    path = _npz(path)
    with np.load(path, allow_pickle=False) as z:
        if str(z["magic"]) != MAGIC:
            raise ValueError(f"{path}: not a rocalution_tpu binary file")
        if str(z["fmt"]) != "csr":
            raise ValueError(f"{path}: unsupported format {z['fmt']!r}")
        return CSR.from_arrays(z["data"], z["indices"], z["indptr"],
                               (int(z["nrow"]), int(z["ncol"])),
                               device=device)


def write_vector(path: str, v, binary: bool = True) -> None:
    """Vector IO (reference: LocalVector::WriteFile{ASCII,Binary}); a
    tensor is read back to the host first."""
    v = v.cpu().numpy() if hasattr(v, "cpu") else np.asarray(v)
    if binary:
        np.savez(_npz(path), magic=MAGIC, version=VERSION, fmt="vec",
                 data=v)
    else:
        np.savetxt(path, v)


def read_vector(path: str, binary: bool = True) -> np.ndarray:
    """A vector written by `write_vector`, as a host array."""
    if binary:
        path = _npz(path)
        with np.load(path, allow_pickle=False) as z:
            if str(z["magic"]) != MAGIC or str(z["fmt"]) != "vec":
                raise ValueError(f"{path}: not a rocalution_tpu vector file")
            return z["data"]
    return np.loadtxt(path)
