"""Format conversions (reference: src/base/host/host_conversion.cpp,
any <-> CSR <-> any).

Counterpart of rocalution_tpu/formats/convert.py. Conversions are setup
work (like the reference's `ConvertTo`) and run on the host with numpy;
the result's tensors go to the source matrix's device. CSR is the hub.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import numpy_dtype, torch_dtype
from .base import MatrixBase, get_host, set_host_cache, to_device
from .bcsr import BCSR
from .coo import COO
from .csr import CSR
from .dense import DENSE
from .dia import DIA
from .ell import ELL
from .hyb import HYB
from .mcsr import MCSR
from .stencil import Stencil
from .wjd import (TILE, WJD, ComplexWJD, compact_entries,
                  from_csr as _wjd_from_csr, unpack_bf16_slices)

FORMATS = {
    "CSR": CSR,
    "COO": COO,
    "ELL": ELL,
    "DIA": DIA,
    "HYB": HYB,
    "BCSR": BCSR,
    "MCSR": MCSR,
    "DENSE": DENSE,
    "WJD": WJD,
}


def _coo_of(csr: CSR):
    """Host (rows, cols, vals) of a CSR."""
    return csr.numpy_rows(), get_host(csr, "indices"), get_host(csr, "data")


def _host_values(mat, name: str) -> np.ndarray:
    """`get_host` of a value array; a bfloat16 one comes back as f32
    holding the same values (exact), the port's host form of bfloat16:
    numpy has no bfloat16."""
    t = getattr(mat, name)
    if isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16:
        return t.float().cpu().numpy()
    return get_host(mat, name)


def to_csr(mat) -> CSR:
    """Convert any format to CSR (host-side), on the matrix's device."""
    if isinstance(mat, CSR):
        return mat
    if not isinstance(mat, MatrixBase):
        raise TypeError(f"cannot convert {type(mat).__name__} to CSR")
    dev = mat.device

    def build(rows, cols, vals):
        return CSR.from_coo(rows, cols, vals, mat.shape, device=dev)

    if isinstance(mat, COO):
        return build(get_host(mat, "row"), get_host(mat, "col"),
                     get_host(mat, "data"))
    if isinstance(mat, ELL):
        ind = get_host(mat, "indices")
        dat = get_host(mat, "data")
        rows = np.broadcast_to(np.arange(mat.shape[0])[:, None], ind.shape)
        mask = ind >= 0
        return build(rows[mask], ind[mask], dat[mask])
    if isinstance(mat, DIA):
        dat = get_host(mat, "data")
        n, m = mat.shape
        rows_all, cols_all, vals_all = [], [], []
        for d, off in enumerate(mat.offsets):
            rows = np.arange(max(0, -off), min(n, m - off))
            vals = dat[d, rows]
            keep = vals != 0
            rows_all.append(rows[keep])
            cols_all.append(rows[keep] + off)
            vals_all.append(vals[keep])
        if rows_all:
            return build(np.concatenate(rows_all), np.concatenate(cols_all),
                         np.concatenate(vals_all))
        return build([], [], np.zeros(0, dat.dtype))
    if isinstance(mat, HYB):
        ra, ca, va = _coo_of(to_csr(mat.ell))
        rb, cb, vb = _coo_of(to_csr(mat.coo))
        return build(np.concatenate([ra, rb]), np.concatenate([ca, cb]),
                     np.concatenate([va, vb]))
    if isinstance(mat, BCSR):
        blocks = get_host(mat, "data")       # (nnzb, bd, bd)
        brow = get_host(mat, "row_ids").astype(np.int64)
        bcol = get_host(mat, "indices").astype(np.int64)
        bd = mat.block_dim
        br, bc = np.nonzero(np.ones((bd, bd), dtype=bool))
        rows = (brow[:, None] * bd + br[None, :]).reshape(-1)
        cols = (bcol[:, None] * bd + bc[None, :]).reshape(-1)
        vals = blocks.reshape(-1)
        keep = (vals != 0) & (rows < mat.shape[0]) & (cols < mat.shape[1])
        return build(rows[keep], cols[keep], vals[keep])
    if isinstance(mat, MCSR):
        rows, cols, vals = _coo_of(mat.offd)
        n = min(mat.shape)
        diag = get_host(mat, "diag")[:n]
        drows = np.arange(n)[diag != 0]
        return build(np.concatenate([rows, drows]),
                     np.concatenate([cols, drows]),
                     np.concatenate([vals, diag[diag != 0]]))
    if isinstance(mat, DENSE):
        return CSR.from_dense(get_host(mat, "data"), device=dev)
    if isinstance(mat, Stencil):
        return mat.to_csr()
    if isinstance(mat, ComplexWJD):
        re, im = to_csr(mat.re), to_csr(mat.im)
        vdt = np.dtype(mat.value_dtype)
        rr, rc, rv = _coo_of(re)
        ir, ic, iv = _coo_of(im)
        return build(np.concatenate([rr, ir]), np.concatenate([rc, ic]),
                     np.concatenate([rv.astype(vdt), 1j * iv.astype(vdt)]))
    if isinstance(mat, WJD):
        # rebuild COO from the slot planes, or from the compact slice form
        # where a gather-mode plan carries no planes (explicit zeros are
        # dropped, as in every padded-format round trip). A bfloat16 plan
        # gives a bfloat16 CSR, as in the JAX package; its host copy holds
        # the values in f32 (`_host_values`)
        if mat.data is None:
            fields = ("slice_ptr", "xbase")
            if mat.cpack is not None:      # the packed form of a bf16 plan
                c = unpack_bf16_slices(
                    *(get_host(mat, f) for f in ("cpack",) + fields),
                    chi=None if mat.chi is None else get_host(mat, "chi"))
                form = tuple(c[f] for f in ("cval", "coff") + fields)
            else:
                form = (_host_values(mat, "cval"),
                        *(get_host(mat, f) for f in ("coff",) + fields))
            rows, xoff, slot_vals = compact_entries(*form)
            cols = xoff - mat.pad_lo
        else:
            val = _host_values(mat, "data")
            brow = get_host(mat, "brow").astype(np.int64)
            tt, kk, ss, ll = np.nonzero(val)
            if mat.uloc is None:                          # roll mode
                u = np.maximum(get_host(mat, "diag_u"), 0).astype(
                    np.int64)[tt, kk]
            else:
                u = get_host(mat, "uloc")[tt, kk, ss, ll].astype(np.int64)
            rows = tt * TILE + ss * 128 + ll
            cols = brow[tt, kk] * 128 - mat.pad_lo + ss * 128 + ll + u
            slot_vals = val[tt, kk, ss, ll]
        rows = np.concatenate([rows, get_host(mat, "spill_row")])
        cols = np.concatenate([cols, get_host(mat, "spill_col")])
        vals = np.concatenate([slot_vals, _host_values(mat, "spill_val")])
        if mat.dia_data is not None:     # the split-off dense diagonals
            dia = to_csr(DIA(data=torch.from_numpy(_host_values(
                mat, "dia_data")), offsets=mat.dia_offsets, shape=mat.shape))
            dr, dc, dv = _coo_of(dia)
            rows, cols, vals = (np.concatenate([rows, dr]),
                                np.concatenate([cols, dc]),
                                np.concatenate([vals, dv]))
        out = build(rows, cols, vals)
        if mat.dtype == torch.bfloat16:
            host = out._host_cache
            out = dataclasses.replace(out, data=out.data.to(torch.bfloat16))
            set_host_cache(out, **host)
        return out
    raise TypeError(f"cannot convert {type(mat).__name__} to CSR")


def cast_values(mat, dtype):
    """Cast a format's value arrays to `dtype`: on the host where the
    matrix has a host cache (CSR, DIA), else tensor by tensor."""
    np_dt, t_dt = numpy_dtype(dtype), torch_dtype(dtype)
    if isinstance(mat, CSR) and getattr(mat, "_host_cache", None):
        d, i, p = mat.numpy_triplet()
        return CSR.from_arrays(d.astype(np_dt), i, p, mat.shape,
                               device=mat.device)
    if isinstance(mat, DIA):
        dat = get_host(mat, "data").astype(np_dt)
        out = DIA(data=to_device(dat, mat.device), offsets=mat.offsets,
                  shape=mat.shape)
        set_host_cache(out, data=dat)
        return out

    def cast(v):
        if isinstance(v, MatrixBase):
            return cast_values(v, t_dt)
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            return v.to(t_dt)
        return v

    return dataclasses.replace(mat, **{
        f.name: cast(getattr(mat, f.name)) for f in dataclasses.fields(mat)})


def convert(mat, fmt: str, **kwargs):
    """Convert a matrix to the named format (analog LocalMatrix::ConvertTo)."""
    fmt = fmt.upper()
    if fmt not in FORMATS:
        raise ValueError(f"unknown format {fmt!r}; options: {sorted(FORMATS)}")
    if type(mat).__name__ == fmt:
        return mat
    csr = to_csr(mat)
    if fmt == "CSR":
        return csr
    if fmt == "COO":
        return COO.from_arrays(*_coo_of(csr), csr.shape, device=csr.device)
    if fmt == "ELL":
        return ELL.from_csr_host(csr, **kwargs)
    if fmt == "DIA":
        return DIA.from_csr_host(csr)
    if fmt == "HYB":
        return HYB.from_csr_host(csr, **kwargs)
    if fmt == "BCSR":
        return BCSR.from_csr_host(csr, kwargs.get("block_dim", 4))
    if fmt == "MCSR":
        return MCSR.from_csr_host(csr)
    if fmt == "WJD":
        return _wjd_from_csr(csr, **kwargs)
    return DENSE.from_csr_host(csr)
