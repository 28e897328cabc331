"""Carry operands across from the JAX package as numpy arrays.

Nothing here imports jax: callers hand over numpy arrays (for example
``{k: np.asarray(v) for k, v in ...}`` of a JAX ``WJD``'s fields; a field
that is itself a matrix, such as ``HYB.ell``, becomes a dict of its own).
"""

from __future__ import annotations

import numpy as np
import torch

from .config import resolve_device
from .formats import (BCSR, COO, CSR, DENSE, DIA, ELL, HYB, MCSR, WJD,
                      ComplexWJD)
from .formats.base import set_host_cache, to_device
from .formats.wjd import _plan_to_wjd

_WJD_ARRAYS = ("data", "uloc", "brow", "diag_u", "win_base", "dia_data",
               "spill_row", "spill_col", "spill_val")
_WJD_STATICS = ("dia_offsets", "shape", "pad_lo", "xp_len", "nnz", "group",
                "wlog", "win_rows", "kernel_mode")


def csr_from_numpy(data, indices, indptr, shape, device=None) -> CSR:
    """CSR on ``device`` from a host triplet."""
    return CSR.from_arrays(np.asarray(data), np.asarray(indices),
                           np.asarray(indptr), shape,
                           device=resolve_device(device))


def _bf16_as_f32(a: np.ndarray) -> np.ndarray:
    """An ml_dtypes bfloat16 array as f32, taken by its bits (exact)."""
    bits = torch.from_numpy(np.array(a).view(np.uint16).view(np.int16))
    return bits.view(torch.bfloat16).float().numpy()


def wjd_from_numpy(fields: dict, device=None) -> WJD:
    """WJD on ``device`` from the JAX ``WJD``'s fields as numpy. An f64
    float-float operand arrives as f32 ``data`` (hi) + ``data_lo`` (lo)
    planes and becomes one f64 plane, hi + lo (a sum f64 holds exactly).
    A bfloat16 operand's value arrays (ml_dtypes, recognised by the dtype's
    name) become the port's host form of a bfloat16 plan: f32 arrays of
    the same values, with ``value_dtype="bfloat16"``."""
    plan = {k: (None if fields.get(k) is None else np.asarray(fields[k]))
            for k in _WJD_ARRAYS}
    plan.update({k: fields[k] for k in _WJD_STATICS if k in fields})
    lo = fields.get("data_lo")
    if lo is not None:
        plan["data"] = plan["data"].astype(np.float64) + np.asarray(
            lo).astype(np.float64)
    if plan["data"].dtype.name == "bfloat16":
        for key in ("data", "spill_val", "dia_data"):
            if plan[key] is not None:
                plan[key] = _bf16_as_f32(plan[key])
        plan["value_dtype"] = "bfloat16"
    return _plan_to_wjd(plan, device=resolve_device(device))


def matrix_from_numpy(fmt: str, fields: dict, device=None):
    """Matrix of format `fmt` on ``device`` from the fields of the JAX
    object of the same name as numpy arrays and plain values."""
    device = resolve_device(device)
    fmt = fmt.upper()
    if fmt == "COMPLEXWJD":
        # the JAX ComplexWJD's two real planes, each as a WJD's fields
        return ComplexWJD(re=wjd_from_numpy(fields["re"], device=device),
                          im=wjd_from_numpy(fields["im"], device=device),
                          value_dtype=str(fields["value_dtype"]))
    shape = tuple(int(v) for v in fields["shape"])
    if fmt == "CSR":
        return csr_from_numpy(fields["data"], fields["indices"],
                              fields["indptr"], shape, device=device)
    if fmt == "COO":
        return COO.from_arrays(fields["row"], fields["col"], fields["data"],
                               shape, device=device)
    if fmt == "ELL":
        return ELL.from_host_planes(np.asarray(fields["data"]),
                                    np.asarray(fields["indices"], np.int32),
                                    shape, device)
    if fmt == "HYB":
        return HYB(ell=matrix_from_numpy("ELL", fields["ell"], device),
                   coo=matrix_from_numpy("COO", fields["coo"], device),
                   shape=shape)
    if fmt == "MCSR":
        diag = np.asarray(fields["diag"])
        out = MCSR(diag=to_device(diag, device), shape=shape,
                   offd=matrix_from_numpy("CSR", fields["offd"], device))
        set_host_cache(out, diag=diag)
        return out
    if fmt == "DENSE":
        return DENSE.from_array(fields["data"], device=device)
    if fmt == "DIA":
        dat = np.asarray(fields["data"])
        out = DIA(data=to_device(dat, device), shape=shape,
                  offsets=tuple(int(o) for o in fields["offsets"]))
        set_host_cache(out, data=dat)
        return out
    if fmt == "BCSR":
        blocks = np.asarray(fields["data"])
        cols = np.asarray(fields["indices"], np.int32)
        rows = np.asarray(fields["row_ids"], np.int64)
        out = BCSR(data=to_device(blocks, device),
                   indices=to_device(cols, device),
                   indptr=to_device(fields["indptr"], device, np.int32),
                   row_ids=to_device(rows, device, np.int32),
                   block_dim=int(fields["block_dim"]), shape=shape)
        set_host_cache(out, data=blocks, indices=cols, row_ids=rows)
        return out
    if fmt == "WJD":
        return wjd_from_numpy(fields, device=device)
    raise ValueError(f"unknown format {fmt!r}")
