"""IO: MatrixMarket text, the package's binary container and rocsparseio.

Counterpart of rocalution_tpu/io (reference: host_io.cpp MTX, the
rocsparseio binary container), and the per-rank layout of a distributed
operator (`write_global_csr`, `read_global_csr`). Readers build on the card unless the caller passes ``device="cpu"``.
"""

from .binary import (read_csr, read_global_csr, read_vector, write_csr,
                     write_global_csr, write_vector)
from .mtx import read_mtx, read_mtx_vector, write_mtx
from .rocsparseio import (read_rocsparseio, read_vector_rocsparseio,
                          write_rocsparseio, write_vector_rocsparseio)

__all__ = [
    "read_csr", "read_global_csr", "read_mtx", "read_mtx_vector", "read_rocsparseio",
    "read_vector", "read_vector_rocsparseio", "write_csr", "write_global_csr", "write_mtx",
    "write_rocsparseio", "write_vector", "write_vector_rocsparseio",
]
