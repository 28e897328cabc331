"""The package's binary sparse-matrix and vector container.

Counterpart of rocalution_tpu/io/binary.py (reference: the rocsparseio
versioned container, src/utils/rocsparseio.{h,hpp,cpp}, behind
LocalMatrix::WriteFileCSR/ReadFileCSR and LocalVector's binary IO): a
self-describing ``.npz`` (magic, version, format tag, index and value
arrays), the same files as the JAX package's, which each package reads.
The per-rank layout of a distributed operator (`write_global_csr`,
`read_global_csr`) is the JAX package's too.
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


# array fields of GlobalCSR persisted per rank, split into the interior
# file (matrix shards) and the pm file (topology shards), mirroring the
# reference's matrix.rank.N / parallelmanager.dat.rank.N split
_GLOBAL_MAT_FIELDS = ("int_data", "int_cols", "int_rows",
                      "ghost_data", "ghost_cols", "ghost_rows")
_GLOBAL_PM_FIELDS = ("send_idx", "recv_idx", "send_off")


def write_global_csr(prefix: str, Ag) -> None:
    """Per-rank distributed matrix layout (reference: the
    ``matrix.mtx.interior.rank.N`` / ``parallelmanager.dat.rank.N`` files,
    docs/api-reference/multinode.rst:126-155, samples/global-io_mpi.cpp):
    one matrix shard file (interior + ghost) and one topology shard file
    per part, plus a JSON descriptor of every static field, from the
    operator's host arrays. The files are the JAX package's, byte for
    byte (the .npz members carry the clock's time, as numpy writes
    them)."""
    import json

    P = Ag.nparts
    meta = {
        "magic": MAGIC, "version": VERSION, "nparts": P,
        "n_global": int(Ag.n_global), "n_local": int(Ag.n_local),
        "n_global_col": int(Ag.n_global_col),
        "n_local_col": int(Ag.n_local_col),
        "shape": [int(Ag.shape[0]), int(Ag.shape[1])],
        "shifts": [int(s) for s in Ag.shifts],
        "mode": Ag.mode,
        "int_nnz": [int(k) for k in Ag.int_nnz],
    }
    with open(f"{prefix}.pm.json", "w") as f:
        json.dump(meta, f)
    mat = {k: get_host(Ag, k) for k in _GLOBAL_MAT_FIELDS}
    pm = {k: get_host(Ag, k) for k in _GLOBAL_PM_FIELDS}
    for p in range(P):
        np.savez(f"{prefix}.matrix.rank.{p}.npz",
                 magic=MAGIC, version=VERSION, fmt="global-shard",
                 **{k: v[p] for k, v in mat.items()})
        np.savez(f"{prefix}.pm.rank.{p}.npz",
                 magic=MAGIC, version=VERSION, fmt="pm-shard",
                 **{k: v[p] for k, v in pm.items()})


def read_global_csr(prefix: str, device=None):
    """The GlobalCSR written by `write_global_csr` (either package's), on
    ``device`` (reference: ParallelManager::ReadFileASCII + the per-rank
    matrix and ghost reads). It carries no interior plans and no host
    block cache, as in the JAX package."""
    import json

    from ..config import resolve_device
    from ..parallel.partition import from_host_arrays

    with open(f"{prefix}.pm.json") as f:
        meta = json.load(f)
    if meta.get("magic") != MAGIC:
        raise ValueError(f"{prefix}.pm.json: not a rocalution_tpu PM file")
    P = int(meta["nparts"])
    host = {k: [] for k in _GLOBAL_MAT_FIELDS + _GLOBAL_PM_FIELDS}
    for p in range(P):
        for kind, fields, fmt in (("matrix", _GLOBAL_MAT_FIELDS,
                                   "global-shard"),
                                  ("pm", _GLOBAL_PM_FIELDS, "pm-shard")):
            with np.load(f"{prefix}.{kind}.rank.{p}.npz",
                         allow_pickle=False) as z:
                if str(z["fmt"]) != fmt:
                    raise ValueError(f"{prefix}.{kind}.rank.{p}: bad "
                                     f"{kind} shard file")
                for k in fields:
                    host[k].append(z[k])
    return from_host_arrays(
        {k: np.stack(v) for k, v in host.items()}, resolve_device(device),
        nparts=P,
        n_local=int(meta["n_local"]),
        n_global=int(meta["n_global"]),
        shape=tuple(meta["shape"]),
        n_local_col=int(meta["n_local_col"]),
        n_global_col=int(meta["n_global_col"]),
        shifts=tuple(meta["shifts"]),
        mode=str(meta["mode"]),
        int_nnz=tuple(meta.get("int_nnz", ())),
    )
