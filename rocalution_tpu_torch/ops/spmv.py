"""Sparse matrix-vector (and multi-vector) products for every format.

Counterpart of rocalution_tpu/ops/spmv.py:

* CSR/COO -> gather + `index_add_` (the plain path), or the attached WJD;
* ELL     -> one gather + dense (nrow, width) multiply + row reduction;
* DIA     -> pad x once, then one shifted slice per diagonal;
* BCSR    -> one batched product over the dense blocks;
* MCSR    -> diagonal multiply + CSR off-diagonal part;
* DENSE   -> plain matrix product;
* WJD     -> the hand-written Hopper kernels (ops/cuda/spmv_wjd.py).

`x` may be (m,) or (m, k): every path serves blocked right-hand sides.

`attach_wjd` builds a WJD plan for a host-built CSR (the analog of
rocSPARSE csrmv analysis); solvers auto-attach through `as_operator` when
the operand lives on CUDA (config.auto_wjd), and route ELL, HYB and BCSR
operands through a WJD plan as well.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import get_config
from ..formats import (BCSR, COO, CSR, DENSE, DIA, ELL, HYB, MCSR, WJD,
                       MatrixBase)
from ..formats.base import expand, get_host, set_host_cache
from ..formats.dia import dia_apply
from .cuda.spmv_wjd import wjd_spmm, wjd_spmv


@functools.singledispatch
def spmv(A, x):
    """y = A @ x (reference: Operator::Apply, src/base/operator.hpp)."""
    if callable(A):  # matrix-free operator
        return A(x)
    raise TypeError(f"spmv: unsupported operator type {type(A).__name__}")


@spmv.register(WJD)
def _spmv_wjd(A: WJD, x):
    if x.dim() != 1:
        return wjd_spmm(A, x)
    return wjd_spmv(A, x)


def _segment_sum(prod, rows, nrow: int):
    """Sum the rows of `prod` into `nrow` segments by row index."""
    out = prod.new_zeros((nrow,) + tuple(prod.shape[1:]))
    return out.index_add_(0, rows, prod)


@spmv.register(CSR)
def _spmv_csr(A: CSR, x):
    wjd = getattr(A, "_wjd_cache", None)
    if wjd is not None and _use_kernel(wjd, x.dtype):
        return spmv(wjd, x)
    prod = expand(A.data, x.index_select(0, A.indices))
    return _segment_sum(prod, A.row_ids, A.shape[0])


def _use_kernel(wjd: WJD, xdt) -> bool:
    """Can this WJD plan serve a rhs of dtype `xdt`? The JAX package's
    `_use_pallas`: an f32 or bfloat16 x rides an f32 or bfloat16 plan, an
    f64 x an f64 plan."""
    if xdt in (torch.float32, torch.bfloat16):
        return wjd.dtype in (torch.float32, torch.bfloat16)
    if xdt == torch.float64:
        return wjd.dtype == torch.float64
    return False


@spmv.register(DIA)
def _spmv_dia(A: DIA, x):
    return dia_apply(A.data, A.offsets, A.shape, x)


@spmv.register(COO)
def _spmv_coo(A: COO, x):
    prod = expand(A.data, x.index_select(0, A.col))
    return _segment_sum(prod, A.row, A.shape[0])


def _routed(A, x):
    """Serve an ELL/HYB/BCSR apply through an attached WJD plan."""
    wjd = getattr(A, "_wjd_cache", None)
    if wjd is not None and _use_kernel(wjd, x.dtype):
        return spmv(wjd, x)
    return None


@spmv.register(ELL)
def _spmv_ell(A: ELL, x):
    y = _routed(A, x)
    if y is not None:
        return y
    xs = x[A.indices.clamp(min=0).long()]          # (nrow, width[, k])
    # padded entries have data == 0, so the product needs no mask
    return expand(A.data, xs).sum(dim=1)


@spmv.register(HYB)
def _spmv_hyb(A: HYB, x):
    y = _routed(A, x)
    if y is not None:
        return y
    return _spmv_ell(A.ell, x) + _spmv_coo(A.coo, x)


@spmv.register(BCSR)
def _spmv_bcsr(A: BCSR, x):
    y = _routed(A, x)
    if y is not None:
        return y
    bd = A.block_dim
    ncolb = -(-A.shape[1] // bd)
    xk = x[:, None] if x.dim() == 1 else x
    k = xk.shape[1]
    pad = ncolb * bd - xk.shape[0]
    if pad:
        xk = torch.cat([xk, xk.new_zeros((pad, k))])
    xb = xk.reshape(ncolb, bd, k)[A.indices.long()]     # (nnzb, bd, k)
    yb = _segment_sum(torch.bmm(A.data, xb), A.row_ids, A.nrowb)
    y = yb.reshape(A.nrowb * bd, k)[: A.shape[0]]
    return y[:, 0] if x.dim() == 1 else y


@spmv.register(MCSR)
def _spmv_mcsr(A: MCSR, x):
    n = min(A.shape)
    y = _spmv_csr(A.offd, x)
    y[:n] += expand(A.diag[:n], x[:n])
    return y


@spmv.register(DENSE)
def _spmv_dense(A: DENSE, x):
    return torch.matmul(A.data, x)


def attach_wjd(A: CSR, **kwargs) -> CSR:
    """Attach a WJD fast-apply plan to a host-built CSR (the analog of
    rocSPARSE csrmv analysis). Later `spmv(A, x)` calls on the SAME object
    go through the WJD kernels; kwargs go to the planner (``split_dia``,
    ``kernel_mode``, ``max_slots``, ``wlog``, ``values_dtype``: with
    ``values_dtype="bfloat16"`` the plan holds bfloat16 values and serves
    an f32 x with f32 sums). A failed plan raises."""
    from ..formats.wjd import from_csr

    object.__setattr__(A, "_wjd_cache", from_csr(A, **kwargs))
    return A


def _wjd_eligible(A: CSR) -> bool:
    """Host triplet available + a value dtype the kernels serve."""
    cache = getattr(A, "_host_cache", None)
    if not cache or "data" not in cache:
        return False
    return np.dtype(cache["data"].dtype) in (np.float32, np.float64)


# formats whose plain apply is gather-bound: solvers route them through a
# WJD conversion (the reference ships device SpMV kernels for them)
_WJD_ROUTED = (ELL, HYB, BCSR)


def auto_wjd_applies(A) -> bool:
    """Whether the solvers plan A for the WJD kernels at setup
    (config.auto_wjd; default: when A's tensors live on CUDA). Auto-attach,
    the factors' off-diagonal parts and the AMG level formats all read
    this one rule."""
    auto = get_config().auto_wjd
    if auto is None:
        auto = A.device.type == "cuda"
    return auto


def maybe_attach_wjd(A):
    """Auto-attach WJD to a host-built CSR, and to ELL, HYB and BCSR
    operands by way of CSR, when the fast path applies (config.auto_wjd;
    default = when the operand's tensors live on CUDA). The analog of the
    reference running csrmv analysis in Solver::Build. An operand without
    host arrays (values computed on the device, or a `cast_values` copy of
    an ELL, HYB or BCSR) has its arrays read back once, here. A conversion
    that fails raises: there is no quiet way around the kernel."""
    if not isinstance(A, (CSR,) + _WJD_ROUTED):
        return A
    if getattr(A, "_wjd_cache", None) is not None or not auto_wjd_applies(A):
        return A
    if isinstance(A, CSR):
        if "data" not in (getattr(A, "_host_cache", None) or {}):
            set_host_cache(A, **{k: get_host(A, k) for k in
                                 ("data", "indices", "indptr", "row_ids")})
        if _wjd_eligible(A):
            attach_wjd(A)
        return A
    # ELL/HYB/BCSR: by way of CSR, from the host arrays where the operand
    # has them, else read back once (a `cast_values` copy has none)
    from ..formats.convert import to_csr
    from ..formats.wjd import from_csr

    csr = to_csr(A)
    if _wjd_eligible(csr):
        object.__setattr__(A, "_wjd_cache", from_csr(csr))
    return A


def as_operator(A):
    """Normalize a matrix / callable into a closure x -> A @ x. CSR, ELL,
    HYB and BCSR operands get the WJD fast path attached here (setup
    phase)."""
    if callable(A) and not isinstance(A, MatrixBase):
        return A
    maybe_attach_wjd(A)
    return lambda x: spmv(A, x)
