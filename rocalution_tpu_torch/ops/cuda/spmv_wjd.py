"""WJD SpMV and SpMM: hand-written Hopper kernels, wrappers, plain versions.

Counterpart of rocalution_tpu/ops/pallas/spmv_wjd.py. Its eight Pallas
kernels are templated CUDA kernels in three sources here:

* ``csrc/spmv_wjd.cu``: the direct single-RHS kernels (`_kernel`,
  `_kernel_roll`, `_kernel_ff`, `_kernel_roll_ff`), four C entry points;
  the two gather entry points read the plan's row-compacted slice form
  (formats/wjd.py:`compact_slices`), the two roll ones its slot planes;
* ``csrc/spmv_wjd_win.cu``: the slot product with x read through per-step
  windows (`_kernel_hbm`, `_kernel_roll_hbm`, `_kernel_roll_ff_hbm`), for
  plans in the windowed regime (formats/wjd.py:`windowed`); the gather
  entry point reads the window-relative compact form
  (`WJD.window_relative`);
* ``csrc/spmm_wjd.cu``: blocked right-hand sides (`_kernel_mrhs`), at most
  16 columns a launch, lanes across the columns; gather mode on the
  compact form, roll mode on the slot planes.

See those files for the designs. The wrappers pad x, launch on the current
stream, add the COO spill and the DIA part, and trim to n.

Value types: f64 and f32, and bfloat16 for the kernels the JAX package
runs on bfloat16 values (all but the two f64 ones): those take an f32 x
and sum in f32 into an f32 y (its `acc_dt`). A bfloat16 x is widened to
f32 first, which is exact and is the product the JAX kernels compute. The
spill and the DIA part promote to f32 the same way.

A complex operator is a `ComplexWJD`, a real and an imaginary WJD plane
on one layout (`cwjd_spmv`): the real and imaginary parts of x go as two
columns of one blocked product through each plane's SpMM kernel, two
launches a product.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
PyTorch version (``slots_plain*``), which is also the oracle the kernels
are checked against on the card.
"""

from __future__ import annotations

import ctypes

import torch

from ...formats.dia import dia_apply
from ...formats.wjd import SLICE, TILE, WJD, ComplexWJD, windowed
from . import _build

# Kernel launches per entry point, counted where the wrapper launches.
launches = {
    "roll_f64": 0, "gather_f64": 0, "roll_f32": 0, "gather_f32": 0,
    "win_roll_f64": 0, "win_roll_f32": 0, "win_gather_f32": 0,
    "spmm_roll_f64": 0, "spmm_gather_f64": 0, "spmm_roll_f32": 0,
    "spmm_gather_f32": 0, "roll_bf16": 0, "gather_bf16": 0,
    "win_roll_bf16": 0, "win_gather_bf16": 0, "spmm_roll_bf16": 0,
    "spmm_gather_bf16": 0,
}

# columns one SpMM launch serves; the kernel is instantiated for these
# widths, and a narrower chunk is padded up with zero columns
MRHS_MAX_COLS = 16
_MRHS_WIDTHS = (4, 8, 16)

_DTYPE_TAG = {torch.float64: "f64", torch.float32: "f32",
              torch.bfloat16: "bf16"}
_COFF_DTYPES = (torch.uint16, torch.int32)
_P, _INT, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# (library, prefix of the launch counters, argument types after the plan's
# operands) per family of roll kernels, which read the slot planes
_FAMILIES = {
    # xp, y, Tp, K, stream
    "spmv": ("spmv_wjd", "", [_P, _P, _I64, _INT, _P]),
    # win_base, xp, y, Tp, K, group, win_rows, stream
    "spmv_win": ("spmv_wjd_win", "win_",
                 [_P, _P, _P, _I64, _INT, _INT, _INT, _P]),
    # xp, y, Tp, K, kc, stream
    "spmm": ("spmm_wjd", "spmm_", [_P, _P, _I64, _INT, _INT, _P]),
}
_SLOT_ARGS = [_P, _P, _P]           # data, brow, diag_u
# the compact gather kernels: cval, coff, coff_bytes, slice_ptr, xbase, then
# xp, y, nslices, stream (spmv) or xp, y, nslices, kc, stream (spmm)
_COMPACT_ARGS = [_P, _P, _INT, _P, _P]
_COMPACT_TAILS = {"spmv": ("spmv_wjd", "", [_P, _P, _I64, _P]),
                  "spmm": ("spmm_wjd", "spmm_", [_P, _P, _I64, _INT, _P])}
# wjd_spmv_win_gather_{f32,bf16}: cval, coff, coff_bytes, slice_ptr,
# win_base, xp, y, nsteps, slices a step, stream
_WIN_COMPACT_ARGS = [_P, _P, _INT, _P, _P, _P, _P, _I64, _INT, _P]


def build() -> None:
    """Build (at first use) the package's kernel libraries."""
    _build.build_all()


_entry_points: dict = {}


def _call(lib: str, name: str, argtypes, counter: str, xp: torch.Tensor,
          *args):
    """Call entry point `name` on the current stream of xp's device; raise
    unless the launch succeeds; count it. The runtime launches on the
    thread's current device, so another device is made current for the
    call."""
    fn = _entry_points.get(name)
    if fn is None:
        fn = getattr(_build.load(lib), name)
        fn.argtypes = argtypes
        fn.restype = _INT
        _entry_points[name] = fn
    dev = xp.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    if dev.index == torch.cuda.current_device():
        rc = fn(*args, stream)
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    launches[counter] += 1


def _launch(family: str, A: WJD, tag: str, xp: torch.Tensor, *args):
    """Launch roll kernel wjd_<family>_roll_<tag> on the plan's planes."""
    lib, prefix, tail = _FAMILIES[family]
    _call(lib, f"wjd_{family}_roll_{tag}", _SLOT_ARGS + tail,
          f"{prefix}roll_{tag}", xp, A.data.data_ptr(), A.brow.data_ptr(),
          A.diag_u.data_ptr(), *args)


def _launch_compact(family: str, A: WJD, tag: str, xp: torch.Tensor, *args):
    """Launch gather kernel wjd_<family>_gather_<tag> on the compact form."""
    lib, prefix, tail = _COMPACT_TAILS[family]
    _call(lib, f"wjd_{family}_gather_{tag}", _COMPACT_ARGS + tail,
          f"{prefix}gather_{tag}", xp, A.cval.data_ptr(), A.coff.data_ptr(),
          A.coff.element_size(), A.slice_ptr.data_ptr(), A.xbase.data_ptr(),
          *args)


def pad_x(A: WJD, x: torch.Tensor, cols: int = 0) -> torch.Tensor:
    """x of shape (m,) or (m, k) with pad_lo zero rows in front, zero-padded
    to xp_len rows and, for a 2-D x, to `cols` columns (row-major)."""
    m = A.shape[1]
    if A.xp_len % 128 or A.xp_len < A.pad_lo + m:
        raise ValueError(f"bad WJD plan: xp_len={A.xp_len}, pad_lo="
                         f"{A.pad_lo}, ncol={m}")
    if x.dim() == 1:
        xp = x.new_zeros(A.xp_len)
        xp[A.pad_lo:A.pad_lo + m] = x
    else:
        xp = x.new_zeros((A.xp_len, max(cols, x.shape[1])))
        xp[A.pad_lo:A.pad_lo + m, :x.shape[1]] = x
    return xp


def _padded(A: WJD, x: torch.Tensor, cols: int = 0) -> torch.Tensor:
    """`pad_x` for the wrappers on the card, into a buffer kept on the plan
    per (stream, dtype, width): its pad rows are zeroed once, and a call
    copies x into its middle, one copy in place of an allocation, a fill
    and a copy. Work on one stream runs in order, so the copy of the next
    call waits for the kernel that read the last one. A chunk narrower than
    its width leaves the last columns as an earlier call wrote them: a
    column of the product reads only its own column of x, and the wrapper
    keeps only the chunk's columns."""
    m = A.shape[1]
    width = max(cols, x.shape[1]) if x.dim() == 2 else 0
    key = (torch.cuda.current_stream(x.device).cuda_stream, x.dtype, width)
    bufs = A.__dict__.setdefault("_xpad", {})
    xp = bufs.get(key)
    if xp is None:
        xp = bufs[key] = pad_x(A, x, cols)
    elif x.dim() == 1:
        xp[A.pad_lo:A.pad_lo + m].copy_(x)
    else:
        xp[A.pad_lo:A.pad_lo + m, :x.shape[1]].copy_(x)
    return xp


def _slot_index(A: WJD, base: torch.Tensor) -> torch.Tensor:
    """(Tp, K, 8, 128) element offsets (base[t,k] + s)*128 + l + u."""
    dev = base.device
    s = torch.arange(8, device=dev).view(1, 1, 8, 1)
    l = torch.arange(128, device=dev).view(1, 1, 1, 128)
    if A.uloc is not None:
        u = A.uloc.long()
    else:                         # roll mode: one offset per slot
        u = A.diag_u.long()[:, :, None, None]
    return (base[:, :, None, None] + s) * 128 + l + u


def slots_plain(A: WJD, xp: torch.Tensor) -> torch.Tensor:
    """Plain slot product: y[t,s,l] = sum_k data[t,k,s,l] *
    xp[(brow[t,k] + s)*128 + l + u[t,k,s,l]], summed in x's type (f32
    products of bfloat16 values, as torch promotes them)."""
    return (A.data * xp[_slot_index(A, A.brow.long())]).sum(dim=1)


def slots_plain_windowed(A: WJD, xp: torch.Tensor) -> torch.Tensor:
    """Plain slot product with x read through the per-step windows: tile t
    of step t // group addresses xp from row win_base[step] on, with slot
    base brow - win_base[step]. Raises IndexError if a load leaves its
    window of win_rows rows."""
    wb = A.win_base.long().repeat_interleave(A.group)[:, None]      # (Tp, 1)
    local = _slot_index(A, A.brow.long() - wb)
    if local.numel() and (int(local.min()) < 0
                          or int(local.max()) >= A.win_rows * 128):
        raise IndexError(f"a slot load leaves its x window of "
                         f"{A.win_rows} rows")
    return (A.data * xp[wb[:, :, None, None] * 128 + local]).sum(dim=1)


def _per_column(slots, A: WJD, xp: torch.Tensor) -> torch.Tensor:
    """Plain blocked-RHS product: `slots` per column of the row-major
    (xp_len, kc) padded X; returns (Tp*1024, kc)."""
    cols = [slots(A, xp[:, j].contiguous()).reshape(-1)
            for j in range(xp.shape[1])]
    return torch.stack(cols, dim=1)


def slots_plain_mrhs(A: WJD, xp: torch.Tensor) -> torch.Tensor:
    """`slots_plain` per column of padded X."""
    return _per_column(slots_plain, A, xp)


def _compact_product(A: WJD, xp: torch.Tensor,
                     base: torch.Tensor) -> torch.Tensor:
    """Element p of slice i multiplies xp[base[i] + coff[p]] and adds to
    row i*32 + p % 32 (every slice starts at a multiple of 32). Gather,
    multiply, sum by row; returns (Tp, 8, 128)."""
    nslices = base.numel()
    sl = torch.repeat_interleave(
        torch.arange(nslices, device=xp.device), A.slice_ptr.diff())
    lane = torch.arange(A.cval.numel(), device=xp.device) % SLICE
    prod = A.cval * xp[base[sl] + A.coff.long()]
    y = xp.new_zeros(nslices * SLICE).index_add_(0, sl * SLICE + lane, prod)
    return y.view(-1, 8, 128)


def slots_plain_compact(A: WJD, xp: torch.Tensor) -> torch.Tensor:
    """Plain product over the compact slice form of a gather-mode plan,
    each slice's offsets taken from its base xbase[i]."""
    return _compact_product(A, xp, A.xbase)


def _check_window_relative(A: WJD) -> None:
    if not A.window_relative:
        raise ValueError("the windowed gather product takes the window-"
                         "relative compact form (a plan built in the "
                         "windowed regime)")


def slots_plain_compact_windowed(A: WJD, xp: torch.Tensor) -> torch.Tensor:
    """Plain product over the window-relative compact form with x read
    through the per-step windows: the offsets of the slices of step i are
    taken from win_base[i]*128. Raises IndexError if a load leaves its
    window of win_rows rows, ValueError for a per-slice compact form. The
    same terms in the same order as `slots_plain_compact`."""
    _check_window_relative(A)
    if A.coff.numel() and int(A.coff.int().max()) >= A.win_rows * 128:
        raise IndexError(f"a compact load leaves its x window of "
                         f"{A.win_rows} rows")
    return _compact_product(A, xp, A.win_base.long().repeat_interleave(
        A.group * (TILE // SLICE)) * 128)


def slots_plain_compact_mrhs(A: WJD, xp: torch.Tensor) -> torch.Tensor:
    """`slots_plain_compact` per column of padded X."""
    return _per_column(slots_plain_compact, A, xp)


def _check_operands(A: WJD, xp: torch.Tensor, compact: bool = False) -> str:
    """Raise unless the kernels take these operands (the plan's slot
    planes, or its compact slice form); return the value type's tag. The
    plan's own tensors do not change, so they are checked once per plan
    and form; xp is checked every call."""
    tag = _DTYPE_TAG.get(A.dtype)
    if tag is None or xp.dtype != A.x_dtype:
        raise TypeError(f"WJD kernel takes f64 or f32 values with x of the "
                        f"same dtype, or bf16 values with an f32 x, got "
                        f"{A.dtype} and {xp.dtype}")
    if not xp.is_cuda:
        raise ValueError("WJD kernels take CUDA tensors only")
    if not xp.is_contiguous():
        raise ValueError("padded x must be contiguous")
    checked = A.__dict__.setdefault("_checked", {})
    if checked.get(compact) != xp.device:
        _check_plan(A, xp.device, compact)
        checked[compact] = xp.device
    return tag


def _check_plan(A: WJD, device: torch.device, compact: bool) -> None:
    if compact:
        operands = [A.cval, A.coff, A.slice_ptr, A.xbase]
        if A.kernel_mode != "gather" or any(t is None for t in operands):
            raise ValueError("the compact kernels take a gather-mode WJD "
                             "with its compact slice form")
        if A.coff.dtype not in _COFF_DTYPES or A.cval.dtype != A.dtype:
            raise TypeError("compact WJD offsets must be uint16/int32 and "
                            "its values of the plan's dtype")
        if (A.slice_ptr.dtype != torch.int64 or A.xbase.dtype != torch.int64):
            raise TypeError("compact WJD slice_ptr/xbase must be int64")
        Tp = A.brow.shape[0]
        if (A.xbase.numel() != Tp * (TILE // SLICE)
                or A.slice_ptr.numel() != A.xbase.numel() + 1
                or A.coff.shape != A.cval.shape):
            raise ValueError("compact WJD arrays do not match the plan's "
                             f"{Tp} tiles")
    else:
        if A.data is None:
            raise ValueError("this WJD carries no slot planes on "
                             f"{A.device}: its compact form serves it")
        if A.kernel_mode != "roll":
            raise ValueError("the slot-plane kernels take a roll-mode WJD, "
                             f"not {A.kernel_mode!r}")
        operands = [A.data, A.brow, A.diag_u]
        if A.brow.dtype != torch.int32 or A.diag_u.dtype != torch.int32:
            raise TypeError("WJD brow/diag_u must be int32")
        Tp, K = A.brow.shape
        if tuple(A.data.shape) != (Tp, K, 8, 128):
            raise ValueError(f"WJD data shape {tuple(A.data.shape)} != "
                             f"{(Tp, K, 8, 128)}")
    for t in operands:
        if t.device != device or not t.is_contiguous():
            raise ValueError("WJD kernel operands must be contiguous and on "
                             f"{device}")


def slots_kernel(A: WJD, xp: torch.Tensor) -> torch.Tensor:
    """Slot product through the direct kernel (CUDA tensors only): over the
    slot planes in roll mode, over the compact form in gather mode."""
    compact = A.kernel_mode == "gather"
    tag = _check_operands(A, xp, compact)
    if tuple(xp.shape) != (A.xp_len,):
        raise ValueError(f"padded x must have shape ({A.xp_len},)")
    Tp, K = A.brow.shape
    y = torch.empty((Tp, 8, 128), dtype=xp.dtype, device=xp.device)
    if compact:
        _launch_compact("spmv", A, tag, xp, xp.data_ptr(), y.data_ptr(),
                        A.xbase.numel())
    else:
        _launch("spmv", A, tag, xp, xp.data_ptr(), y.data_ptr(), Tp, K)
    return y


def slots_kernel_windowed(A: WJD, xp: torch.Tensor) -> torch.Tensor:
    """Slot product through the windowed kernel (CUDA tensors only): over
    the slot planes in roll mode, over the window-relative compact form in
    gather mode (f32 or bf16 values only)."""
    compact = A.kernel_mode == "gather"
    tag = _check_operands(A, xp, compact)
    if tuple(xp.shape) != (A.xp_len,):
        raise ValueError(f"padded x must have shape ({A.xp_len},)")
    Tp, K = A.brow.shape
    wb = A.win_base
    if (wb is None or wb.dtype != torch.int32 or wb.device != xp.device
            or not wb.is_contiguous() or A.group <= 0 or Tp % A.group
            or tuple(wb.shape) != (Tp // A.group,) or A.win_rows <= 0):
        raise ValueError("windowed WJD kernel needs an int32 win_base of "
                         "one entry per step of `group` tiles")
    y = torch.empty((Tp, 8, 128), dtype=xp.dtype, device=xp.device)
    if not compact:
        _launch("spmv_win", A, tag, xp, wb.data_ptr(), xp.data_ptr(),
                y.data_ptr(), Tp, K, A.group, A.win_rows)
        return y
    if tag == "f64":
        raise TypeError("gather mode has no windowed kernel for f64 values")
    _check_window_relative(A)
    _call("spmv_wjd_win", f"wjd_spmv_win_gather_{tag}", _WIN_COMPACT_ARGS,
          f"win_gather_{tag}", xp, A.cval.data_ptr(), A.coff.data_ptr(),
          A.coff.element_size(), A.slice_ptr.data_ptr(), wb.data_ptr(),
          xp.data_ptr(), y.data_ptr(), wb.numel(),
          A.group * (TILE // SLICE))
    return y


def slots_kernel_mrhs(A: WJD, xp: torch.Tensor) -> torch.Tensor:
    """Blocked-RHS slot product through the SpMM kernel (CUDA tensors
    only). xp is padded X of 4, 8 or 16 columns, row-major (xp_len, kc);
    the result is (Tp*1024, kc). Roll mode reads the slot planes, gather
    mode the compact form."""
    compact = A.kernel_mode == "gather"
    tag = _check_operands(A, xp, compact)
    kc = xp.shape[1] if xp.dim() == 2 else 0
    if kc not in _MRHS_WIDTHS or tuple(xp.shape) != (A.xp_len, kc):
        raise ValueError(f"padded X must have {_MRHS_WIDTHS} columns of "
                         f"{A.xp_len} rows, got {tuple(xp.shape)}")
    Tp, K = A.brow.shape
    y = torch.empty((Tp * TILE, kc), dtype=xp.dtype, device=xp.device)
    if compact:
        _launch_compact("spmm", A, tag, xp, xp.data_ptr(), y.data_ptr(),
                        A.xbase.numel(), kc)
    else:
        _launch("spmm", A, tag, xp, xp.data_ptr(), y.data_ptr(), Tp, K, kc)
    return y


def _x_of(A: WJD, x: torch.Tensor, dim: int) -> torch.Tensor:
    """x as the plan takes it: of the plan's x dtype (a bfloat16 x where
    that is f32 is widened to it, exactly); raise on a shape, dtype or
    device the plan does not take."""
    m = A.shape[1]
    if x.dim() != dim or x.shape[0] != m:
        want = f"({m},)" if dim == 1 else f"({m}, k)"
        raise ValueError(f"x must have shape {want}, got {tuple(x.shape)}")
    xdt = A.x_dtype
    if x.dtype == torch.bfloat16 and xdt == torch.float32:
        x = x.float()
    if x.dtype != xdt or x.device != A.device:
        raise TypeError(f"x ({x.dtype}, {x.device}) does not match the WJD "
                        f"operand ({A.dtype}, {A.device})")
    return x


def _apply(A: WJD, x: torch.Tensor, slots) -> torch.Tensor:
    n = A.shape[0]
    x = _x_of(A, x, 1)
    if A.nnz == 0:
        y = x.new_zeros(n)
    else:
        xp = _padded(A, x) if x.is_cuda else pad_x(A, x)
        y = slots(A, xp).reshape(-1)[:n]
        if A.spill_row.numel():
            y.index_add_(0, A.spill_row,
                         A.spill_val * x.index_select(0, A.spill_col))
    if A.dia_data is not None:
        y = y + dia_apply(A.dia_data, A.dia_offsets, A.shape, x)
    return y


def _apply_mrhs(A: WJD, X: torch.Tensor, slots) -> torch.Tensor:
    """The reference's outer structure (`wjd_spmm`): DIA part, empty plan,
    column chunks of at most MRHS_MAX_COLS, COO spill, trim to n."""
    n = A.shape[0]
    X = _x_of(A, X, 2)
    k = X.shape[1]
    if A.nnz == 0 or k == 0:
        Y = X.new_zeros((n, k))
    else:
        outs = []
        for j0 in range(0, k, MRHS_MAX_COLS):
            kc = min(MRHS_MAX_COLS, k - j0)
            width = next(w for w in _MRHS_WIDTHS if w >= kc)
            Xc = X[:, j0:j0 + kc]
            y = slots(A, _padded(A, Xc, width) if X.is_cuda
                      else pad_x(A, Xc, width))
            outs.append(y[:n, :kc])
        Y = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0].contiguous()
        if A.spill_row.numel():
            Y.index_add_(0, A.spill_row, A.spill_val[:, None]
                         * X.index_select(0, A.spill_col))
    if A.dia_data is not None:
        Y = Y + dia_apply(A.dia_data, A.dia_offsets, A.shape, X)
    return Y


def wjd_spmv(A: WJD, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for a WJD matrix; single right-hand side. A CUDA tensor
    launches a kernel: the windowed one where the plan is in the windowed
    regime (formats/wjd.py:`windowed`), else the direct one (gather mode:
    on the compact form, in both). A CPU tensor takes the plain version of
    the same. y has the plan's x dtype (f32 for bfloat16 values)."""
    gather = A.kernel_mode == "gather"
    if windowed(A, A.x_dtype):
        if x.is_cuda:
            slots = slots_kernel_windowed
        else:
            slots = (slots_plain_compact_windowed if gather
                     else slots_plain_windowed)
    elif x.is_cuda:
        slots = slots_kernel
    else:
        slots = (slots_plain_compact if A.kernel_mode == "gather"
                 else slots_plain)
    return _apply(A, x, slots)


def wjd_spmm(A: WJD, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for X of shape (m, k): blocked right-hand sides, at most
    MRHS_MAX_COLS columns a launch. A CUDA tensor launches the SpMM kernel
    (on the compact form in gather mode); a CPU tensor takes the plain
    version of the same."""
    if X.is_cuda:
        slots = slots_kernel_mrhs
    else:
        slots = (slots_plain_compact_mrhs if A.kernel_mode == "gather"
                 else slots_plain_mrhs)
    return _apply_mrhs(A, X, slots)


def _cwjd(C: ComplexWJD, x: torch.Tensor, real_apply, cols_apply):
    """y = C @ x from real applies of the planes: y = (Ar xr - Ai xi) +
    i (Ar xi + Ai xr). A complex x of shape (m,) or (m, k) is read as its
    real view, whose rows hold (xr, xi) side by side: an (m, 2) or
    (m, 2k) real X, row-major, the layout the SpMM kernel takes, so each
    plane serves both parts in one blocked product (`cols_apply`). A real
    x needs one apply a plane (`real_apply`)."""
    if not x.is_complex():
        return torch.complex(real_apply(C.re, x), real_apply(C.im, x))
    m = x.shape[0]
    X = torch.view_as_real(x.resolve_conj()).reshape(m, -1)
    yr = cols_apply(C.re, X).view(-1, *x.shape[1:], 2)
    yi = cols_apply(C.im, X).view(-1, *x.shape[1:], 2)
    return torch.complex(yr[..., 0] - yi[..., 1], yr[..., 1] + yi[..., 0])


def _spmv_any(A: WJD, x: torch.Tensor) -> torch.Tensor:
    return wjd_spmv(A, x) if x.dim() == 1 else wjd_spmm(A, x)


def cwjd_spmv(C: ComplexWJD, x: torch.Tensor) -> torch.Tensor:
    """y = C @ x for a ComplexWJD and x of shape (m,) or (m, k): each
    plane's blocked product over the real view of x (CUDA: the SpMM
    kernel, two launches a product; CPU: its plain version). complex64
    takes f32 (or bfloat16) planes, complex128 f64 planes."""
    return _cwjd(C, x, _spmv_any, wjd_spmm)


def cwjd_reference(C: ComplexWJD, x: torch.Tensor) -> torch.Tensor:
    """The reference's formula from the planes' plain products (any
    device): y = (Ar xr - Ai xi) + i (Ar xi + Ai xr)."""
    return _cwjd(C, x, wjd_reference, wjd_reference)


def wjd_reference(A: WJD, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch WJD product on any device, for x of shape (m,) or
    (m, k): gather + sum over the padded slots wherever the WJD carries its
    slot planes, else over the compact form."""
    padded = A.data is not None
    if x.dim() == 1:
        return _apply(A, x, slots_plain if padded else slots_plain_compact)
    return _apply_mrhs(A, x, slots_plain_mrhs if padded
                       else slots_plain_compact_mrhs)


def slot_bytes(A: WJD, compact: bool = False,
               through_windows: bool = False) -> int:
    """Operand bytes one kernel call streams from the plan: slot values
    with brow and diag_u (roll mode), or the compact form's values,
    offsets, slice_ptr and xbase (the windowed gather kernel reads
    win_base in place of xbase)."""
    if compact:
        base = A.win_base if through_windows else A.xbase
        return sum(t.numel() * t.element_size()
                   for t in (A.cval, A.coff, A.slice_ptr, base))
    Tp, K = A.brow.shape
    return Tp * K * (TILE * A.dtype.itemsize + 2 * 4)
