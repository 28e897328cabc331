"""One part per process over torch.distributed (the MPI flow).

Counterpart of rocalution_tpu/parallel/multiproc.py (reference: every
rank builds its OWN matrix part and ParallelManager from local data plus
point-to-point boundary messages, src/base/parallel_manager.cpp:726-782,
docs/api-reference/multinode.rst:126-155; then all ranks run the same
solver). The only setup exchange the GlobalCSR layout needs is each
part's GHOST COLUMN LIST (boundary-size metadata), carried by
`allgather_host`; everything else (send lists, shifts, receive maps) is
derived by every process alike. The process's GlobalCSR holds its own
part (leading axis of length 1), and the solve is the single-process one
with a `ProcessComm` (parallel/comm.py) in place of the stacked parts.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..config import resolve_device
from .comm import ProcessComm, process_comm
from .partition import (_halo_layout, _pad1, from_host_arrays,
                        plans_interiors)

__all__ = ["allgather_host", "process_comm", "global_csr_multiproc",
           "dist_solve_spmd"]


def allgather_host(arr: np.ndarray, comm: ProcessComm):
    """All-gather a variable-length 1-D host array across the processes:
    the lengths, then the payloads padded to the longest (the
    size-prefixed boundary-index messages of parallel_manager.cpp:
    726-782). Returns one numpy array per process."""
    dist = comm.dist
    arr = np.asarray(arr)
    n = torch.tensor([arr.shape[0]], dtype=torch.int64)
    lens = [torch.empty_like(n) for _ in range(comm.nparts)]
    dist.all_gather(lens, n, group=comm.group)
    lens = [int(v[0]) for v in lens]
    L = max(1, max(lens))
    pad = np.zeros(L, arr.dtype if arr.size else np.int64)
    pad[: arr.shape[0]] = arr
    t = torch.from_numpy(pad)
    out = [torch.empty_like(t) for _ in range(comm.nparts)]
    dist.all_gather(out, t, group=comm.group)
    return [o.numpy()[:k] for o, k in zip(out, lens)]


def global_csr_multiproc(block, shape, comm: ProcessComm, *,
                         max_neighbor_shifts: int = 6,
                         wjd: Optional[bool] = None, device=None):
    """The GlobalCSR of THIS process's row block, on ``device``.

    `block` = (local_rows, global_cols, values) for the rows
    [rank*nl, (rank+1)*nl) of the global operator (nl = ceil(n/P)), the
    block format of `global_csr_from_blocks`; no process sees another
    part's values, and only the ghost column lists and entry counts cross
    processes. ``wjd``: plan the interior part (None = the auto rule,
    `partition.plans_interiors`); the part is planned alone, since the
    kernel runs once per process."""
    device = resolve_device(device)
    pid, Pn = comm.rank, comm.nparts
    n, ncol = int(shape[0]), int(shape[1])
    square = n == ncol
    nl = -(-n // Pn)
    ncl = nl if square else -(-ncol // Pn)
    n_pad = nl * Pn

    r = np.asarray(block[0], np.int64)
    c = np.asarray(block[1], np.int64)
    d = np.asarray(block[2])
    if square and n_pad > n and pid == Pn - 1:
        extra = np.arange(n, n_pad, dtype=np.int64)
        r = np.concatenate([r, extra - pid * nl])
        c = np.concatenate([c, extra])
        d = np.concatenate([d, np.ones(n_pad - n, d.dtype)])
    order = np.lexsort((c, r))
    r, c, d = r[order], c[order], d[order]

    # ghost metadata exchange: with the entry counts below, the ONLY
    # cross-process setup traffic
    owner = c // ncl
    my_ghost = np.unique(c[owner != pid])
    ghost_cols_of = allgather_host(my_ghost, comm)

    # send lists, shifts and receive maps of every part follow from the
    # gathered lists alone; this process keeps its own
    send_of, recv_of, send_off, shifts = _halo_layout(
        ghost_cols_of, ncl, max_neighbor_shifts)
    max_send = max(1, max(len(v) for v in send_of))
    max_ghost = max(1, max(len(g) for g in ghost_cols_of))

    # interior / ghost split of OWN rows
    imask = (c // ncl) == pid
    gmask = ~imask
    gcols = np.searchsorted(ghost_cols_of[pid], c[gmask])
    nnz_int = max(1, int(max(int(v[0]) for v in allgather_host(
        np.asarray([int(imask.sum())], np.int64), comm))))
    nnz_gst = max(1, int(max(int(v[0]) for v in allgather_host(
        np.asarray([int(gmask.sum())], np.int64), comm))))

    def one(a, length, fill, dt):
        return _pad1(a, length, fill).astype(dt)[None]

    host = dict(
        int_data=one(d[imask], nnz_int, 0, d.dtype),
        int_cols=one(c[imask] - pid * ncl, nnz_int, 0, np.int32),
        int_rows=one(r[imask], nnz_int, nl - 1, np.int32),
        ghost_data=one(d[gmask], nnz_gst, 0, d.dtype),
        ghost_cols=one(gcols, nnz_gst, 0, np.int32),
        ghost_rows=one(r[gmask], nnz_gst, nl - 1, np.int32),
        send_idx=one(send_of[pid], max_send, 0, np.int32),
        recv_idx=one(recv_of[pid], max_ghost, 0, np.int32),
        send_off=send_off[pid:pid + 1].astype(np.int32),
    )
    if wjd is None:
        wjd = plans_interiors(device, d.dtype)
    int_wjd = None
    if wjd:
        from ..formats.wjd import stack_wjd

        ri, ci, di = r[imask], c[imask] - pid * ncl, d[imask]
        indptr = np.zeros(nl + 1, np.int64)
        np.add.at(indptr, ri + 1, 1)
        int_wjd = stack_wjd([(di, ci, np.cumsum(indptr))], (nl, ncl),
                            device=device)
    return from_host_arrays(
        host, device, int_wjd=int_wjd, nparts=Pn, n_local=nl, n_global=n,
        shape=(n, ncol), n_local_col=0 if square else ncl,
        n_global_col=0 if square else ncol, shifts=shifts,
        mode="ppermute" if shifts else "allgather",
        int_nnz=(int(imask.sum()),))


def dist_solve_spmd(solver: Callable, A, b_local, comm: ProcessComm, *,
                    inv_diag_local=None, x_true_local=None, **kwargs):
    """Run a solver over the processes on a `global_csr_multiproc`
    operator. `b_local` (and the optional Jacobi `inv_diag_local` and
    reference `x_true_local`) is THIS process's (n_local,) slice. Returns
    (x_own, info, err): `err` is the GLOBAL ||x - x_true||_2, summed over
    the processes (NaN without x_true_local); the solution is never
    gathered."""
    from .ops import shard_operator

    dev = A.device

    def local(v):
        return torch.as_tensor(np.asarray(v), device=dev)

    b = local(b_local)
    M = None
    if inv_diag_local is not None:
        inv = local(inv_diag_local)
        M = lambda r: inv * r                               # noqa: E731
    x, info = solver(shard_operator(A, comm), b, None, M, axis_name=comm,
                     **kwargs)
    err = float("nan")
    if x_true_local is not None:
        err = float(torch.sqrt(comm.psum(
            torch.sum((x - local(x_true_local)) ** 2)[None])))
    return x, info, err
