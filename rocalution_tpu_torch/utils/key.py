"""Matrix fingerprinting (reference: LocalMatrix::Key(), local_matrix.hpp:
a three-part structural/numeric hash that identifies a matrix).

Counterpart of rocalution_tpu/utils/key.py: the same three sha256 prefixes
over the same bytes (int64 shape, int64 indices then indptr, the values),
so both packages give one matrix the same key.
"""

from __future__ import annotations

import hashlib
from typing import Tuple

import numpy as np

from ..formats import to_csr
from ..formats.base import get_host


def matrix_key(A) -> Tuple[int, int, int]:
    """(structure_key, pattern_key, value_key): any difference in shape,
    sparsity pattern or values changes the corresponding component."""
    csr = to_csr(A)
    h1 = hashlib.sha256(
        np.asarray(csr.shape, np.int64).tobytes()
    ).digest()[:8]
    h2 = hashlib.sha256(
        get_host(csr, "indices").astype(np.int64).tobytes()
        + get_host(csr, "indptr").astype(np.int64).tobytes()
    ).digest()[:8]
    h3 = hashlib.sha256(get_host(csr, "data").tobytes()).digest()[:8]
    return (
        int.from_bytes(h1, "little"),
        int.from_bytes(h2, "little"),
        int.from_bytes(h3, "little"),
    )
