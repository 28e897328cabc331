"""Block preconditioners: BlockJacobi, BlockPreconditioner, (R)AS.

Counterpart of rocalution_tpu/precond/block.py (reference:
preconditioner_blockjacobi, preconditioner_blockprecond and
preconditioner_as: BlockJacobi with a direct local solver, the
block-diagonal or block-lower composition of per-block solvers, and
(restricted) additive Schwarz with ``Set(num_blocks, overlap)``, whose AS
recombines the overlap with weights 1/count and whose RAS keeps each
block's own rows).

The diagonal blocks are gathered on the host into one (nb, w, w) stack,
padded with the identity, and inverted once by the same batched
`np.linalg.inv` as the JAX package's; the port gathers them in one
vectorized pass where the JAX package extracts block by block. Every
apply is one gather, one batched matvec on the device and, for (R)AS, the
weighted scatter-add: the JAX package adds the blocks one after another;
the port adds the even blocks, then the odd ones, which is the same sum
bit for bit while no slot lies in two blocks of one pass (an overlap of
at most half a block), and adds block by block otherwise.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..formats import CSR, to_csr
from ..formats.base import get_host, to_device
from ..ops.extract import block_sizes, extract_submatrix
from ..ops.spmv import maybe_attach_wjd, spmv


def _block_stack(A: CSR, starts, ends, width: int) -> np.ndarray:
    """(nb, width, width) stack whose block k holds A[s_k:e_k, s_k:e_k]
    in its leading corner and the identity on the rest of its diagonal.
    Blocks may overlap; each nonzero lands in every block that holds both
    its row and its column."""
    data = get_host(A, "data")
    r = get_host(A, "row_ids").astype(np.int64)
    c = get_host(A, "indices").astype(np.int64)
    nb = len(starts)
    out = np.zeros((nb, width, width), dtype=data.dtype)
    sizes = ends - starts
    pad_k, pad_t = np.nonzero(np.arange(width)[None, :] >= sizes[:, None])
    out[pad_k, pad_t, pad_t] = 1.0
    # the blocks that can hold row r lie within reach of r's own block
    # (starts are nondecreasing and every block is at most `width` long)
    first = np.searchsorted(ends, r, side="right")     # first k: e_k > r
    last = np.searchsorted(starts, r, side="right")    # k < last: s_k <= r
    for d in range(int((last - first).max(initial=0))):
        k = first + d
        ok = k < last
        k_ok = k[ok]
        s_k = starts[k_ok]
        inside = (c[ok] >= s_k) & (c[ok] < ends[k_ok])
        out[k_ok[inside], (r[ok] - s_k)[inside],
            (c[ok] - s_k)[inside]] = data[ok][inside]
    return out


def block_jacobi(A, num_blocks: int = 8):
    """BlockJacobi: z_k = (A_kk)^{-1} r_k per contiguous diagonal block.
    Setup inverts the (nb, bs, bs) stack once; apply = one batched
    matvec."""
    csr = A if isinstance(A, CSR) else to_csr(A)
    n = csr.shape[0]
    bs = -(-n // num_blocks)
    offsets = np.minimum(np.arange(num_blocks + 1) * bs, n)
    blocks = _block_stack(csr, offsets[:-1], offsets[1:], bs)
    inv = to_device(np.linalg.inv(blocks), csr.device)
    pad = num_blocks * bs - n

    def apply(r):
        rp = torch.cat([r, r.new_zeros(pad)]) if pad else r
        zb = torch.einsum("kij,kj->ki", inv, rp.reshape(num_blocks, bs))
        return zb.reshape(-1)[:n]

    return apply


def block_precond(A, num_blocks: int, solvers: Sequence[Callable],
                  *, lower: bool = False):
    """BlockPreconditioner: block-diagonal (default) or block-lower-
    triangular composition of per-block preconditioner closures
    (reference: BlockPreconditioner SetDiagonalSolver / SetLSolver).
    `solvers[k]` is a closure r_k -> z_k for diagonal block k."""
    csr = A if isinstance(A, CSR) else to_csr(A)
    sizes = block_sizes(csr.shape[0], num_blocks)
    offs = np.concatenate([[0], np.cumsum(sizes)]).astype(int)
    off_blocks = {}
    if lower:
        for i in range(num_blocks):
            for j in range(i):
                off_blocks[(i, j)] = maybe_attach_wjd(extract_submatrix(
                    csr, offs[i], offs[j], sizes[i], sizes[j]))

    def apply(r):
        zs: List[torch.Tensor] = []
        for i in range(num_blocks):
            ri = r[offs[i]:offs[i + 1]]
            if lower:
                for j in range(i):
                    ri = ri - spmv(off_blocks[(i, j)], zs[j])
            zs.append(solvers[i](ri))
        return torch.cat(zs)

    return apply


def additive_schwarz(A, num_blocks: int = 4, overlap: int = 4,
                     inner: Optional[Callable] = None, *,
                     restricted: bool = False):
    """AS/RAS: overlapping diagonal blocks, a solve on each, weighted
    recombination (reference: AS/RAS Set(nb, overlap, preconds)).
    `inner(block_csr) -> closure` builds the per-block solver (default:
    the dense inverse, all blocks in one batched matvec).
    `restricted=True` gives RAS."""
    csr = A if isinstance(A, CSR) else to_csr(A)
    n = csr.shape[0]
    dev = csr.device
    bs = -(-n // num_blocks)
    k_all = np.arange(num_blocks)
    starts = np.maximum(0, k_all * bs - overlap)
    ends = np.minimum(n, (k_all + 1) * bs + overlap)
    sizes = ends - starts
    width = int(sizes.max())
    valid = np.arange(width)[None, :] < sizes[:, None]
    # gather index of each block slot: its row, or n (a zero) past the
    # block's end; the scatter sends those slots to the scratch row n
    idx = np.where(valid, starts[:, None] + np.arange(width), n)

    if inner is None:
        inv = to_device(np.linalg.inv(_block_stack(csr, starts, ends,
                                                   width)), dev)

        def solve_all(R):
            return torch.einsum("kij,kj->ki", inv, R)
    else:
        closures = [inner(extract_submatrix(csr, s, s, e - s, e - s))
                    for s, e in zip(starts, ends)]

        def solve_all(R):
            return torch.stack([
                torch.cat([clos(R[k, :e - s]),
                           R.new_zeros(width - (e - s))])
                for k, (clos, s, e) in enumerate(zip(closures, starts,
                                                     ends))])

    # recombination weights: RAS keeps each block's own rows, AS weighs
    # the overlapped rows by 1 / the number of blocks that hold them
    if restricted:
        own = idx - (k_all * bs)[:, None]
        weights = ((own >= 0) & (own < bs) & valid).astype(np.float64)
    else:
        counts = np.bincount(idx[valid], minlength=n).astype(np.float64)
        weights = np.where(valid, 1.0 / counts[np.minimum(idx, n - 1)], 0.0)
    weights_d = to_device(weights, dev)
    idx_d = to_device(idx, dev)
    passes = ([k_all % 2 == 0, k_all % 2 == 1] if 2 * overlap <= bs
              else [k_all == k for k in k_all])
    passes = [to_device(np.flatnonzero(p), dev) for p in passes if p.any()]

    def apply(r):
        rp = torch.cat([r, r.new_zeros(1)])
        contrib = weights_d.to(r.dtype) * solve_all(rp[idx_d])
        z = r.new_zeros(n + 1)
        for ks in passes:
            z.index_add_(0, idx_d[ks].reshape(-1),
                         contrib[ks].reshape(-1))
        return z[:n]

    return apply


def restricted_additive_schwarz(A, num_blocks: int = 4, overlap: int = 4,
                                inner: Optional[Callable] = None):
    """RAS (reference: preconditioner_as.hpp RAS variant)."""
    return additive_schwarz(A, num_blocks, overlap, inner, restricted=True)
