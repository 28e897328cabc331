"""Per-part distributed operations.

Counterpart of rocalution_tpu/parallel/ops.py (reference:
GlobalMatrix::Apply with its halo exchange,
src/base/global_matrix.cpp:924-1009): the boundary values are gathered,
exchanged through the communicator (one `ppermute` per neighbour shift,
or one `all_gather` of the fixed-size boundary buffers), the interior
product runs, and the ghost product adds the received values.

Every function takes tensors whose leading axis holds this process's
parts (all P of them, or one) plus a communicator (parallel/comm.py).
Vectors reach the solvers flat, the parts end to end (`shard_operator`).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..formats.wjd import shard_of
from ..ops.cuda.spmv_wjd import wjd_spmv
from ..ops.spmv import _use_kernel
from .partition import GlobalCSR


class _Index(NamedTuple):
    """Flat int64 indices of a GlobalCSR's arrays over the process's
    parts laid end to end (per-part local ids plus the part's offset)."""

    int_rows: torch.Tensor
    int_cols: torch.Tensor
    ghost_rows: torch.Tensor
    ghost_cols: torch.Tensor
    send: Tuple[torch.Tensor, ...]   # per shift (ppermute) or one
    recv: torch.Tensor


def _index(A: GlobalCSR) -> _Index:
    """`_Index` of A, made once per operator and kept on it."""
    got = getattr(A, "_flat_index", None)
    if got is not None:
        return got
    Pl, nl = A.local_parts, A.n_local
    ncl = A.n_local_col or nl
    q = torch.arange(Pl, device=A.device, dtype=torch.int64)[:, None]

    def flat(idx, stride):
        return (idx.long() + q * stride).reshape(-1)

    if A.mode == "ppermute" and A.shifts:
        send = tuple(flat(A.send_off[:, di], ncl)
                     for di in range(len(A.shifts)))
        recv = flat(A.recv_idx, A.send_off.shape[1] * A.send_off.shape[2])
    else:
        send = (flat(A.send_idx, ncl),)
        recv = A.recv_idx.long().reshape(-1)   # one buffer every part shares
    got = _Index(flat(A.int_rows, nl), flat(A.int_cols, ncl),
                 flat(A.ghost_rows, nl),
                 flat(A.ghost_cols, A.recv_idx.shape[1]), send, recv)
    object.__setattr__(A, "_flat_index", got)
    return got


def interior_spmv(A: GlobalCSR, x: torch.Tensor) -> torch.Tensor:
    """(Pl, nl) interior products of (Pl, ncl) x. A planned interior
    launches the serial WJD entry point once per part (P launches an
    apply, as `shard_map` runs the JAX kernel once per shard): on a CUDA
    tensor that launches the kernel or raises. Without a plan (``wjd=False``
    where the JAX package passes it too, or the CPU's default) the
    product is the plain segment sum, as in the JAX package."""
    W = A.int_wjd
    if W is not None and _use_kernel(W.parts[0], x.dtype):
        return torch.stack([wjd_spmv(shard_of(W, q), x[q])
                            for q in range(x.shape[0])])
    ix = _index(A)
    y = x.new_zeros(x.shape[0] * A.n_local)
    y.index_add_(0, ix.int_rows,
                 A.int_data.reshape(-1) * x.reshape(-1)[ix.int_cols])
    return y.view(x.shape[0], A.n_local)


def shard_spmv(A: GlobalCSR, x: torch.Tensor, comm) -> torch.Tensor:
    """y = (A @ x) for this process's parts: x is (Pl, ncl), y (Pl, nl).
    The boundary gather and the exchange come first, then the interior
    product, then the ghost product on the received values, a plain
    segment sum in both packages (its work is the boundary's)."""
    ix = _index(A)
    Pl = x.shape[0]
    xf = x.reshape(-1)
    if A.mode == "ppermute" and A.shifts:
        recv = torch.cat([comm.ppermute(xf[idx].view(Pl, -1), s)
                          for idx, s in zip(ix.send, A.shifts)], dim=1)
    else:
        recv = comm.all_gather(xf[ix.send[0]].view(Pl, -1))
    ghost_vals = recv.reshape(-1)[ix.recv]            # (Pl * max_ghost,)
    y = interior_spmv(A, x).reshape(-1)
    y = y.index_add(0, ix.ghost_rows,
                    A.ghost_data.reshape(-1) * ghost_vals[ix.ghost_cols])
    return y.view(Pl, A.n_local)


def shard_operator(A: GlobalCSR, comm):
    """Closure x -> A @ x over flat vectors (this process's parts end to
    end), for any solver."""
    Pl = A.local_parts
    return lambda x: shard_spmv(A, x.reshape(Pl, -1), comm).reshape(-1)
