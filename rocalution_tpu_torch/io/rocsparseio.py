"""rocsparseio-compatible binary container reader and writer.

Counterpart of rocalution_tpu/io/rocsparseio.py, byte for byte (reference:
the versioned binary container of src/utils/rocsparseio.{h,hpp,cpp},
behind LocalMatrix::WriteFileCSR/ReadFileCSR since rocALUTION 3.0). The
layout is the file format's:

* file header: 16 bytes, the zero-padded ASCII ``ROCSPARSEIO.<major>``;
* a stored object starts with a 512-byte name field (rocsparseio.h:47);
* CSX object (format 2): 9 uint64 scalars [format, direction, m, n, nnz,
  ptr_type, ind_type, data_type, base], then the arrays ptr (m+1 or n+1
  by direction), ind and data (nnz each);
* COO object (format 4): 8 uint64 scalars [format, m, n, nnz,
  row_ind_type, col_ind_type, data_type, base], then row_ind, col_ind,
  data;
* MCSX object (format 8, fwrite_sparse_mcsx, rocsparseio.hpp:1891): the
  name, 9 scalars as CSX, then ptr/ind/data of rocALUTION's modified CSR:
  val[0..m) is the diagonal, ptr[i] >= m indexes row i's off-diagonal run
  in the same arrays (host_matrix_mcsr.cpp:409-419);
* dense vector object (format 0, fwrite_dense_vector,
  rocsparseio.hpp:805): scalars [format, data_type, nmemb] BEFORE the
  name, then the raw data;
* every other array is prefixed by two uint64 words (element size,
  count), then the raw elements (fwrite_array, rocsparseio.hpp:761-769).

Type enum (rocsparseio.h:106-112): 0=int32 1=int64 2=f32 3=f64
4=complex<f32> 5=complex<f64> 6=int8.
"""

from __future__ import annotations

import struct

import numpy as np

from ..config import resolve_device
from ..formats import CSR, MCSR, to_csr
from ..formats.base import get_host, set_host_cache, to_device

VERSION_MAJOR = 1

_FMT_DENSE_VECTOR = 0
_FMT_SPARSE_CSX = 2
_FMT_SPARSE_COO = 4
_FMT_SPARSE_MCSX = 8

_TYPE_TO_DTYPE = {
    0: np.dtype("<i4"), 1: np.dtype("<i8"),
    2: np.dtype("<f4"), 3: np.dtype("<f8"),
    4: np.dtype("<c8"), 5: np.dtype("<c16"),
    6: np.dtype("i1"),
}
_DTYPE_TO_TYPE = {v: k for k, v in _TYPE_TO_DTYPE.items()}

_NAME_BYTES = 512


def _header_words() -> bytes:
    s = f"ROCSPARSEIO.{VERSION_MAJOR}".encode()
    return s + b"\0" * (16 - len(s))


def _read_u64(f, n=1):
    raw = f.read(8 * n)
    if len(raw) != 8 * n:
        raise ValueError("rocsparseio: truncated file")
    vals = struct.unpack(f"<{n}Q", raw)
    return vals[0] if n == 1 else vals


def _write_u64(f, *vals):
    f.write(struct.pack(f"<{len(vals)}Q", *vals))


def _read_array(f, dtype):
    size, nmemb = _read_u64(f, 2)
    if size != dtype.itemsize:
        raise ValueError(
            f"rocsparseio: array element size {size} != dtype {dtype}")
    a = np.fromfile(f, dtype=dtype, count=nmemb)
    if len(a) != nmemb:
        raise ValueError("rocsparseio: truncated array")
    return a


def _write_array(f, a):
    a = np.ascontiguousarray(a)
    _write_u64(f, a.dtype.itemsize, a.size)
    a.tofile(f)


def _mcsr(diag, offd: CSR, shape, device) -> MCSR:
    out = MCSR(diag=to_device(diag, device), offd=offd, shape=shape)
    set_host_cache(out, diag=diag)
    return out


def read_rocsparseio(path: str, device=None):
    """Read a rocsparseio file: a CSX or COO object gives a CSR, an MCSX
    object an MCSR (both on ``device``), a dense vector a host array
    (reference: LocalMatrix::ReadFileCSR, HostMatrixMCSR::ReadFileRSIO,
    LocalVector's binary IO). A matrix object stores its 512-byte name
    first, the dense vector its format word: a leading u64 of 0 is that
    word (a name would have to start with a zero byte)."""
    device = resolve_device(device)
    with open(path, "rb") as f:
        if f.read(16) != _header_words():
            raise ValueError(
                f"{path}: not a rocsparseio v{VERSION_MAJOR} file")
        first = _read_u64(f)
        if first == _FMT_DENSE_VECTOR:
            dat_t, nmemb = _read_u64(f, 2)
            f.read(_NAME_BYTES)
            v = np.fromfile(f, dtype=_TYPE_TO_DTYPE[int(dat_t)],
                            count=int(nmemb))
            if len(v) != int(nmemb):
                raise ValueError(f"{path}: truncated dense vector")
            return v
        f.seek(16)
        f.read(_NAME_BYTES)                 # object name (informational)
        fmt = _read_u64(f)
        if fmt == _FMT_SPARSE_CSX:
            direction, m, n, nnz, ptr_t, ind_t, dat_t, base = _read_u64(f, 8)
            ptr = _read_array(f, _TYPE_TO_DTYPE[int(ptr_t)])
            ind = _read_array(f, _TYPE_TO_DTYPE[int(ind_t)]) - int(base)
            data = _read_array(f, _TYPE_TO_DTYPE[int(dat_t)])
            nptr_want = int(n) + 1 if direction == 1 else int(m) + 1
            if len(ptr) != nptr_want or len(ind) != int(nnz) \
                    or len(data) != int(nnz):
                raise ValueError(
                    f"{path}: inconsistent CSX object: |ptr|={len(ptr)} "
                    f"(want {nptr_want}), |ind|={len(ind)}, "
                    f"|data|={len(data)}, nnz={int(nnz)}")
            if direction == 1:              # CSC: transpose to CSR
                from scipy.sparse import csc_matrix

                A = csc_matrix((data, ind, ptr - int(base)),
                               shape=(m, n)).tocsr()
                return CSR.from_arrays(A.data, A.indices, A.indptr, (m, n),
                                       device=device)
            return CSR.from_arrays(data, ind, ptr - int(base),
                                   (int(m), int(n)), device=device)
        if fmt == _FMT_SPARSE_COO:
            m, n, nnz, row_t, col_t, dat_t, base = _read_u64(f, 7)
            rows = _read_array(f, _TYPE_TO_DTYPE[int(row_t)]) - int(base)
            cols = _read_array(f, _TYPE_TO_DTYPE[int(col_t)]) - int(base)
            data = _read_array(f, _TYPE_TO_DTYPE[int(dat_t)])
            if not (len(rows) == len(cols) == len(data) == int(nnz)):
                raise ValueError(
                    f"{path}: inconsistent COO object: |row|={len(rows)}, "
                    f"|col|={len(cols)}, |data|={len(data)}, nnz={int(nnz)}")
            order = np.lexsort((cols, rows))
            indptr = np.zeros(int(m) + 1, np.int64)
            np.add.at(indptr, rows + 1, 1)
            indptr = np.cumsum(indptr)
            return CSR.from_arrays(data[order], cols[order], indptr,
                                   (int(m), int(n)), device=device)
        if fmt == _FMT_SPARSE_MCSX:
            direction, m, n, nnz, ptr_t, ind_t, dat_t, base = _read_u64(f, 8)
            ptr = (_read_array(f, _TYPE_TO_DTYPE[int(ptr_t)])
                   .astype(np.int64) - int(base))
            ind = (_read_array(f, _TYPE_TO_DTYPE[int(ind_t)])
                   .astype(np.int64) - int(base))
            data = _read_array(f, _TYPE_TO_DTYPE[int(dat_t)])
            m, n = int(m), int(n)
            nptr_want = (n if direction == 1 else m) + 1
            if len(ptr) != nptr_want or len(ind) != int(nnz) \
                    or len(data) != int(nnz):
                raise ValueError(f"{path}: inconsistent MCSX object")
            start = int(ptr[0])
            if direction == 1:
                # MCSC: the same diagonal (square only), off-diagonal runs
                # per column, brought to row direction
                if m != n:
                    raise ValueError(
                        f"{path}: non-square MCSC object unsupported")
                from scipy.sparse import csc_matrix

                offc = csc_matrix((data[start:], ind[start:], ptr - start),
                                  shape=(m, n)).tocsr()
                offc.sort_indices()
                offd = CSR.from_arrays(offc.data, offc.indices, offc.indptr,
                                       (m, n), device=device)
                return _mcsr(data[:n], offd, (m, n), device)
            offd = CSR.from_arrays(data[start:], ind[start:], ptr - start,
                                   (m, n), device=device)
            return _mcsr(data[:m], offd, (m, n), device)
        raise ValueError(f"{path}: unsupported rocsparseio format {fmt}")


def _name_field(name: str) -> bytes:
    nm = name.encode()[: _NAME_BYTES - 1]
    return nm + b"\0" * (_NAME_BYTES - len(nm))


def _typed(data: np.ndarray):
    """(data, type enum): a type the file format has no enum for is
    written as f64."""
    dt = _DTYPE_TO_TYPE.get(data.dtype.newbyteorder("<"))
    if dt is None:
        return data.astype("<f8"), 3
    return data, dt


def _write_sparse(path, name, fmt, m, n, ptr, ind, data):
    # the index width follows the sizes: int32 would wrap at 2^31
    itype = "<i8" if max(m, n, len(data),
                         int(ptr[-1]) if len(ptr) else 0) >= 2**31 else "<i4"
    ind, ptr = ind.astype(itype), ptr.astype(itype)
    data, dt = _typed(data)
    with open(path, "wb") as f:
        f.write(_header_words())
        f.write(_name_field(name))
        _write_u64(f, fmt, 0, m, n, len(data), _DTYPE_TO_TYPE[ptr.dtype],
                   _DTYPE_TO_TYPE[ind.dtype], dt, 0)
        _write_array(f, ptr)
        _write_array(f, ind)
        _write_array(f, data)


def write_rocsparseio(path: str, A, name: str = "rocalution_tpu") -> None:
    """Write a matrix as a rocsparseio object: an MCSR as an MCSX object
    (HostMatrixMCSR::WriteFileRSIO's layout), any other format as a CSX
    object (LocalMatrix::WriteFileCSR), from the host arrays."""
    if isinstance(A, MCSR):
        return _write_mcsx(path, A, name)
    csr = to_csr(A)
    m, n = csr.shape
    _write_sparse(path, name, _FMT_SPARSE_CSX, m, n,
                  np.asarray(get_host(csr, "indptr")),
                  np.asarray(get_host(csr, "indices")),
                  np.asarray(get_host(csr, "data")))


def _write_mcsx(path: str, A: MCSR, name: str) -> None:
    """MCSX object: val[0..m) the diagonal, ptr[i] = m + offd_indptr[i];
    ind[0..m) is unused in the reference's layout and written as 0."""
    diag = np.asarray(get_host(A, "diag"))
    od, oi, op = A.offd.numpy_triplet()
    m, n = A.shape
    data = np.concatenate([diag, od])
    ind = np.concatenate([np.zeros(m, np.int64), oi])
    _write_sparse(path, name, _FMT_SPARSE_MCSX, m, n,
                  (op + m).astype(np.int64), ind, data)


def write_vector_rocsparseio(path: str, v,
                             name: str = "rocalution_tpu") -> None:
    """Dense-vector object (fwrite_dense_vector, rocsparseio.hpp:805): its
    scalars come before the name field and the data is raw."""
    v = v.cpu().numpy() if hasattr(v, "cpu") else np.asarray(v)
    v, dt = _typed(np.ascontiguousarray(v))
    with open(path, "wb") as f:
        f.write(_header_words())
        _write_u64(f, _FMT_DENSE_VECTOR, dt, v.size)
        f.write(_name_field(name))
        v.tofile(f)


def read_vector_rocsparseio(path: str) -> np.ndarray:
    """Read a dense-vector object (see write_vector_rocsparseio)."""
    v = read_rocsparseio(path, device="cpu")
    if not isinstance(v, np.ndarray):
        raise ValueError(f"{path}: not a dense-vector object")
    return v
