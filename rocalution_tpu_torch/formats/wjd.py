"""WJD — windowed jagged-diagonal storage (the device-fast sparse format).

Counterpart of rocalution_tpu/formats/wjd.py; the host planner is copied
from it decision for decision, so both packages build equal plans from
equal arguments:

* Rows are grouped into **tiles of 1024** (row i -> tile t = i//1024,
  s = (i//128)%8, l = i%128).
* Within a tile every nonzero is keyed by its diagonal offset d = col - row
  and bucketed into windows of 2**wlog offsets; the entries of one
  (tile, window, rank) triple form a **slot** of 1024 values plus 1024
  local offsets u (``uloc``). **Roll mode** keys slots by (tile, diagonal)
  instead, so each slot has one offset ``diag_u`` and no uloc plane.
* Element (t, k, s, l) of a slot multiplies
  ``xpad[(brow[t,k] + s)*128 + l + u]``, where xpad is x with ``pad_lo``
  zeros in front, padded to ``xp_len``. Slots beyond ``max_slots`` spill to
  a COO tail. Under ``split_dia`` (the reference's default in f32; not
  the port's, see `csr_to_wjd_plan`), globally dense diagonals split off
  to a DIA part.

On Hopper this is a sliced ELL with a slice height of 1024 (see
ops/cuda/spmv_wjd.py). One deliberate difference from the JAX package: f64
values are stored natively as one f64 plane, not as the f32 hi/lo pair
(which holds 48 of the 53 significand bits) — Hopper has IEEE fp64, and
the byte count is the same.

A slot exists for every (tile, window, rank) that any of a tile's 1024
rows occupies, so a **gather-mode** plan of a scattered operator is mostly
padding (5.6x at 15 nonzeros a row). A TPU's (8, 128) vector unit wants
those dense planes; a warp of 32 threads does not. So a gather-mode plan
also takes a **row-compacted slice form** (`compact_slices`), and that is
what the direct gather kernels read on the card:

* a slice is 32 consecutive rows (one warp), 32 slices a tile;
* each row's real entries are packed to ranks 0..len-1 in ascending slot
  order k, so a row sums the same terms in the same order as the slot
  product, less the padding's ``+ 0*x`` terms;
* a slice is as wide as its longest row and lies rank-major: element
  (rank j, lane) at ``slice_ptr[slice] + j*32 + lane``; short rows are
  padded with value 0 and offset 0;
* an entry's column is its offset into padded x relative to the slice's
  base ``xbase[slice]``, as uint16 where every slice spans fewer than
  65,536 elements of x, else as int32 for the whole plan;
* a plan that the windowed gather kernel serves (`windowed`) takes the
  **window-relative** form (``window_relative``): the base of every slice
  of grid step i is the step's window, ``win_base[i]*128``, so an offset
  lies in [0, win_rows*128), and the kernel needs no ``xbase``. That fits
  2 bytes where every offset is below 65,536, as it is wherever
  ``win_rows*128 <= 65,536``; a wider window may take int32 offsets. The
  direct kernels read the same form through ``xbase``.

A bfloat16 plan, direct or window-relative, takes one of three forms,
chosen by the width of its offsets alone (`_packs`); the form and the
regime then choose the kernel:

* offsets below 2**16: the **packed** form (`pack_bf16_slices`,
  ``cpack``): one 32-bit word a stored element, the value's bfloat16 bits
  in its low half and its offset in its high half, so that a lane reads 4
  ranks of its row with one 16-byte load: word (j, lane) of a slice at
  ``slice_ptr[slice] + (j // 4)*128 + lane*4 + j % 4``, a slice's width
  padded to a multiple of 4 with zero words. ``slice_ptr`` counts words,
  ``xbase`` and ``window_relative`` are the compact form's, and
  ``cval``/``coff`` are None;
* offsets below 2**24: the packed form with a **high byte** a word
  (``packed24``): the same words, holding the offset's low 16 bits, and a
  plane ``chi`` (uint8, one byte a word at the word's own index, padding
  words 0) with its bits 16-23, so that a lane reads 4 ranks with one
  16-byte load of words and one 4-byte load of their high bytes: 5 bytes
  a stored element. A direct plan's offsets lie below ``xp_len``, at most
  X_VMEM_BUDGET bytes of f32 x; a window-relative plan's below
  ``win_rows*128``;
* wider offsets (a window of 2**24 elements of x or more): the compact
  form with int32 offsets.

The padded ``data`` / ``uloc`` planes of a gather-mode plan stay on the
host only (None on the WJD) unless the WJD lives on the CPU.

The planner's cost constants were fitted on a TPU v5e and are kept for
plan parity; refitting them on the H100 is later, measured work.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .base import MatrixBase, to_device

TILE = 1024          # rows per tile
SLICE = 32           # rows per slice of the compact form: one warp
PACK = 4             # ranks of a row in one 16-byte load of the packed form
PACK_REACH = 1 << 24  # offsets the packed form holds with its high byte


def _is_bf16(values_dtype) -> bool:
    """Does `values_dtype` ask for bfloat16 values? None keeps the CSR's."""
    if values_dtype is None:
        return False
    if values_dtype in ("bfloat16", torch.bfloat16):
        return True
    raise ValueError(f"values_dtype must be None or 'bfloat16', got "
                     f"{values_dtype!r}")


def _round_to_bf16(a: np.ndarray) -> np.ndarray:
    """The values of `a` rounded to bfloat16 by torch's cast, as f32."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(
        torch.bfloat16).float().numpy()


def _load_rows(nj: int) -> int:
    """Sublane rows the TPU kernel loads per window (sizes xp_len)."""
    return -(-(8 + nj) // 8) * 8


@dataclasses.dataclass(frozen=True)
class WJD(MatrixBase):
    """Windowed jagged-diagonal matrix (see module docstring)."""

    # (Tp, K, 8, 128) slot values, f32, f64 or bf16; None where a
    # gather-mode plan on the card is served from its compact (or packed)
    # form alone
    data: Optional[torch.Tensor]
    brow: torch.Tensor       # (Tp, K) int32 window base row into padded x
    diag_u: torch.Tensor     # (Tp, K) int32: constant u of diagonal slots, -1 else
    spill_row: torch.Tensor  # (nspill,) int32 COO spill
    spill_col: torch.Tensor  # (nspill,) int32
    spill_val: torch.Tensor  # (nspill,)
    # (Tp, K, 8, 128) local offsets in [0, win); uint8 when win <= 256,
    # else int16. None in roll mode, where u is diag_u for the whole slot.
    uloc: Optional[torch.Tensor] = None
    # per-step first x row of the step's window ((nsteps,) int32): the
    # windowed kernels address x relative to it (see `windowed`)
    win_base: Optional[torch.Tensor] = None
    # hybrid DIA split: dia_data[k, r] = A[r, r + dia_offsets[k]]
    dia_data: Optional[torch.Tensor] = None
    dia_offsets: Tuple[int, ...] = ()
    shape: Tuple[int, int] = (0, 0)
    kernel_mode: str = "gather"       # "gather" | "roll"
    pad_lo: int = 0                   # zeros prepended to x
    xp_len: int = 0                   # padded x length (multiple of 128)
    nnz: int = 0                      # entries held by slots + spill
    group: int = 8                    # tiles per TPU grid step
    wlog: int = 8                     # log2 window width
    win_rows: int = 0                 # x rows per step window
    # row-compacted slice form of a gather-mode plan (`compact_slices`)
    cval: Optional[torch.Tensor] = None       # (total,) values
    coff: Optional[torch.Tensor] = None       # (total,) uint16 | int32
    slice_ptr: Optional[torch.Tensor] = None  # (Tp*32 + 1,) int64
    xbase: Optional[torch.Tensor] = None      # (Tp*32,) int64
    # xbase[slice] is win_base[step of the slice]*128 (module docstring)
    window_relative: bool = False
    # packed form of a bfloat16 plan (`pack_bf16_slices`): (words,) int32,
    # bfloat16 bits | offset << 16; slice_ptr then counts words
    cpack: Optional[torch.Tensor] = None
    # (words,) uint8: bits 16-23 of each word's offset, where an offset of
    # the packed form passes 16 bits (the packed24 form), else None
    chi: Optional[torch.Tensor] = None

    @property
    def _values(self) -> torch.Tensor:
        """The first value array the plan carries on its device."""
        if self.data is not None:
            return self.data
        return self.cval if self.cpack is None else self.cpack

    @property
    def dtype(self) -> torch.dtype:
        if self.data is None and self.cpack is not None:
            return torch.bfloat16
        return self._values.dtype

    @property
    def x_dtype(self) -> torch.dtype:
        """dtype of x, the sums and y: the values' own, but f32 for
        bfloat16 values (the JAX kernels' f32 accumulator)."""
        return torch.float32 if self.dtype == torch.bfloat16 else self.dtype

    @property
    def device(self) -> torch.device:
        return self._values.device

    @property
    def padding_ratio(self) -> float:
        Tp, K = self.brow.shape
        return Tp * K * TILE / max(self.nnz, 1)

    @property
    def compact_form(self) -> Optional[str]:
        """Which form the gather kernels read: "packed" (a bfloat16 plan
        with 16-bit offsets, direct or window-relative), "packed24" (the
        same with a high byte a word: offsets below 2**24), "compact", or
        None for a roll-mode plan."""
        if self.cpack is not None:
            return "packed" if self.chi is None else "packed24"
        return None if self.cval is None else "compact"

    @property
    def compact_padding_ratio(self) -> float:
        """Stored elements of the compact slice form (words of the packed
        form) over the entries held by slots and spill (`padding_ratio`'s
        denominator)."""
        stored = self.cval if self.cpack is None else self.cpack
        return stored.numel() / max(self.nnz, 1)


# per-slot kernel cost model (ns, v5e-measured): base + gathers; spilled
# entries pay the segment-sum rate. The f64 constants model the TPU's
# float-float kernel. Kept as they are so the plans equal the JAX
# package's; an H100 refit is later work.
_COST_BASE = 12.0
_COST_GATHER = 7.6
_COST_SPILL = 25.0
_FF_COST_BASE = 32.0
_FF_COST_SPILL = 50.0
_COST_ROLL = 10.0
_FF_COST_ROLL = 18.0


def _unique_inverse(keys: np.ndarray):
    """``np.unique(keys, return_inverse=True)`` of non-negative int64
    keys. Where the keys span at most a few times their count, a presence
    table gives the same sorted values and inverse without a sort."""
    n = len(keys)
    span = int(keys.max()) + 1 if n else 0
    if n == 0 or span > 4 * n + (1 << 22):
        return np.unique(keys, return_inverse=True)
    present = np.zeros(span, dtype=bool)
    present[keys] = True
    rank = np.cumsum(present, dtype=np.int32 if span < 1 << 31 else np.int64)
    return np.flatnonzero(present), (rank[keys] - 1).astype(np.intp)


def csr_to_wjd_plan(vals, cols, indptr, shape, *, wlog="auto",
                    max_slots: Optional[int] = 128,
                    kernel_mode: str = "auto",
                    values_dtype=None, split_dia=False,
                    cache: bool = True) -> dict:
    """Host-side CSR -> WJD *plan* (numpy arrays + static fields only).

    ``max_slots`` caps slots per tile; entries in hotter slots spill to a
    COO tail. ``kernel_mode``: "gather" | "roll" | "auto" ("auto" picks by
    the per-slot cost model). ``split_dia``: move globally dense diagonals
    to a DIA part ("auto" = f32 values only, the JAX package's default).

    ``values_dtype="bfloat16"``: store the slot values, the spill and the
    DIA part in bfloat16, half the bytes of f32; x, the sums and y stay
    f32 (~1e-3 relative accuracy), for the inner operator of
    MixedPrecisionDC or accuracy-tolerant applies. The layout is planned
    from the values as given and they are rounded afterwards, as the JAX
    package does. numpy has no bfloat16, so the plan's host arrays are f32
    arrays holding the rounded values, with ``value_dtype="bfloat16"``;
    `_plan_to_wjd` casts them to torch.bfloat16 at upload, exactly. The
    rounding is torch's cast, which takes an f64 value through f32 as
    ml_dtypes does: the bits equal the JAX planner's.

    ``vals`` may be (nnz, P): P value planes on one pattern, as for the
    real and imaginary parts of a complex operator (`from_csr`). The layout
    depends on the pattern and the value type only, so the plan is the
    plan of each plane alone, and its value arrays carry the trailing P
    axis.

    ``cache``: persist and reuse the finished plan on disk, keyed by a
    content hash of the triplet and the options (formats/wjd_cache.py), so
    the planning cost is paid once per machine; plans of fewer than
    100,000 entries are always planned again.

    A deliberate difference from the JAX package: the port's default keeps
    every diagonal in the slots, on every device. The reference's "auto"
    rule sends the globally dense diagonals of an f32 operator to a DIA
    part, which XLA serves well on a TPU; on the H100 that part is a few
    plain torch ops per diagonal, and the kernel serves the same diagonals
    for less (f32 CG + SA-AMG, ROADMAP.md section 3, fault 6).
    """
    if _is_bf16(values_dtype):
        # the layout is planned from the values as given and they are
        # rounded afterwards: the plan of their own type (cached or not)
        # serves both types
        return _rounded_to_bf16(csr_to_wjd_plan(
            vals, cols, indptr, shape, wlog=wlog, max_slots=max_slots,
            kernel_mode=kernel_mode, split_dia=split_dia, cache=cache))
    n, m = int(shape[0]), int(shape[1])
    vals = np.asarray(vals)
    cols = np.asarray(cols, dtype=np.int64)
    indptr = np.asarray(indptr, dtype=np.int64)
    nnz = len(vals)
    planes = vals.shape[1:]

    cache_key = None
    if cache and nnz >= 100_000:          # small plans replan faster than IO
        from . import wjd_cache

        cache_key = wjd_cache.plan_key(vals, cols, indptr, shape, {
            "wlog": wlog, "max_slots": max_slots,
            "kernel_mode": kernel_mode, "values_dtype": values_dtype,
            "split_dia": split_dia,
        })
        hit = wjd_cache.load_plan(cache_key)
        if hit is not None:
            return hit

    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))

    # hybrid DIA split: GLOBALLY dense diagonals leave the slot plan
    dia_data = None
    dia_offsets = ()
    do_split = (split_dia if split_dia != "auto"
                else np.dtype(vals.dtype) == np.float32)
    if do_split and nnz:
        d_all = cols - rows
        offs_u, counts = np.unique(d_all, return_counts=True)
        qual = offs_u[counts >= max(1, n // 2)]
        if len(qual) > 64:           # bound the (ndiag, n) side structure
            top = np.argsort(counts[np.isin(offs_u, qual)])[-64:]
            qual = np.sort(qual[top])
        if len(qual):
            mask = np.isin(d_all, qual)
            dia_offsets = tuple(int(o) for o in qual)
            dia_data = np.zeros((len(qual), n) + planes, vals.dtype)
            ki = np.searchsorted(qual, d_all[mask])
            dia_data[ki, rows[mask]] = vals[mask]
            keep = ~mask
            vals, cols, rows = vals[keep], cols[keep], rows[keep]
            nnz = len(vals)

    def _finish(plan_out):
        plan_out["dia_data"] = dia_data
        plan_out["dia_offsets"] = dia_offsets
        if cache_key is not None:
            from . import wjd_cache

            wjd_cache.save_plan(cache_key, plan_out)
        return plan_out

    if nnz == 0:
        empty = np.zeros(0, np.int64)
        return _finish(_assemble(
            vals, empty, empty, empty, empty, 1, n, m, 0, 8,
            spill=(empty, empty, vals), slot_info=None))

    d = cols - rows
    t = rows >> 10

    T = max(1, -(-n // TILE))

    def plan(wl):
        wid = d >> wl                    # arithmetic shift: floor(d / win)
        # rank of each entry within its (row, window) run. CSR stores
        # columns sorted per row, so (row, wid) groups are contiguous runs.
        new_run = np.ones(nnz, dtype=bool)
        new_run[1:] = (rows[1:] != rows[:-1]) | (wid[1:] != wid[:-1])
        run_id = np.cumsum(new_run) - 1
        run_first = np.flatnonzero(new_run)
        rank = np.arange(nnz, dtype=np.int64) - run_first[run_id]
        wmin = int(wid.min())
        wspan = int(wid.max()) - wmin + 1
        rspan = int(rank.max()) + 1
        enc = (t * wspan + (wid - wmin)) * rspan + rank
        slot_enc, inv = _unique_inverse(enc)
        slot_t = slot_enc // (wspan * rspan)
        slot_wid = (slot_enc // rspan) % wspan + wmin
        tile_first = np.searchsorted(slot_t, np.arange(T, dtype=np.int64))
        k_of_slot = (np.arange(len(slot_enc), dtype=np.int64)
                     - tile_first[slot_t])
        return wid, slot_t, slot_wid, k_of_slot, inv

    def cap_cost(k_of_slot_, inv_, slot_cost, spill_cost):
        """Estimated apply time with the best per-tile slot cap: the
        kernel streams T*K slots regardless of occupancy, so pick the cap K
        minimizing T*K*slot_cost + (entries in slots k >= K)*spill_cost."""
        kmax = int(k_of_slot_.max()) + 1
        hist = np.bincount(k_of_slot_[inv_], minlength=kmax).astype(np.int64)
        suffix = np.concatenate([np.cumsum(hist[::-1])[::-1], [0]])
        caps = np.arange(1, kmax + 1)
        costs = T * caps * slot_cost + suffix[caps] * spill_cost
        best_i = int(np.argmin(costs))
        cap = int(caps[best_i])
        if max_slots is not None and cap > max_slots:
            cap = max_slots
        return float(T * cap * slot_cost + suffix[cap] * spill_cost), cap

    def plan_roll(wl):
        """Slots keyed by (tile, diagonal): jagged-diagonal layout."""
        dmin = int(d.min())
        # slots = the sorted distinct (tile, diagonal) pairs, keyed by the
        # rank of the diagonal among the distinct ones (same order)
        d_vals, d_id = _unique_inverse(d - dmin)
        nd = len(d_vals)
        slot_enc, inv_r = _unique_inverse(t * nd + d_id)
        slot_t_r = slot_enc // nd
        slot_d = d_vals[slot_enc % nd] + dmin
        tile_first = np.searchsorted(slot_t_r, np.arange(T, dtype=np.int64))
        k_of_slot_r = (np.arange(len(slot_enc), dtype=np.int64)
                       - tile_first[slot_t_r])
        return (slot_d >> wl, slot_t_r, slot_d >> wl, k_of_slot_r, inv_r,
                slot_d)

    ff_vals = np.dtype(vals.dtype) == np.float64
    spill_c = _FF_COST_SPILL if ff_vals else _COST_SPILL
    roll_c = _FF_COST_ROLL if ff_vals else _COST_ROLL

    # roll candidate first: a clearly banded matrix skips the gather sweep
    cost_r = cap_r = plan_r = None
    if kernel_mode != "gather":
        wl_r = 8 if wlog == "auto" else int(wlog)
        plan_r = plan_roll(wl_r)
        cost_r, cap_r = cap_cost(plan_r[3], plan_r[4], roll_c, spill_c)

    clearly_banded = (
        kernel_mode == "auto" and cap_r is not None and cap_r <= 12
        and cost_r <= 1.05 * (T * cap_r * roll_c)   # spill share tiny
    )

    # gather candidate (window/rank slots, auto window width)
    cost_g = cap_g = plan_g = wl_g = None
    if kernel_mode != "roll" and not clearly_banded:
        best = None
        wls = (8, 10, 11) if wlog == "auto" else (wlog,)
        for wl in wls:
            p = plan(wl)
            nj = (1 << wl) // 128 + 1
            slot_cost = ((_FF_COST_BASE + 2 * nj * _COST_GATHER) if ff_vals
                         else (_COST_BASE + nj * _COST_GATHER))
            c, cap = cap_cost(p[3], p[4], slot_cost, spill_c)
            if best is None or c < best[0]:
                best = (c, wl, cap, p)
            if wlog == "auto" and len(p[3]) * TILE < 2 * nnz:
                break                        # already tight: stop widening
        cost_g, wl_g, cap_g, plan_g = best

    if kernel_mode == "roll" or (kernel_mode == "auto"
                                 and cost_r is not None
                                 and (cost_g is None or cost_r < cost_g)):
        kernel_mode = "roll"
        wlog = 8 if wlog == "auto" else int(wlog)
        wid, slot_t, slot_wid, k_of_slot, inv, slot_d = plan_r
        cap = cap_r
        wid = d >> wlog                  # per-entry wid for u below
    else:
        kernel_mode = "gather"
        wlog = wl_g
        cap = cap_g
        wid, slot_t, slot_wid, k_of_slot, inv = plan_g
        slot_d = None

    k_of_entry = k_of_slot[inv]
    u = (d - (wid << wlog)).astype(np.int64)       # in [0, win)

    # spill entries in slots beyond the cap
    if int(k_of_slot.max()) + 1 > cap:
        keep_slot = k_of_slot < cap
        keep = keep_slot[inv]
        spill = (rows[~keep], cols[~keep], vals[~keep])
        sel = np.flatnonzero(keep)
        rows_k, vals_k, u_k = rows[sel], vals[sel], u[sel]
        t_k, k_e = t[sel], k_of_entry[sel]
        slot_sel = np.flatnonzero(keep_slot)
        slot_t, slot_wid = slot_t[slot_sel], slot_wid[slot_sel]
        k_of_slot = k_of_slot[slot_sel]
        if slot_d is not None:
            slot_d = slot_d[slot_sel]
        K = cap
    else:
        spill = (np.zeros(0, np.int64), np.zeros(0, np.int64),
                 np.zeros((0,) + planes, vals.dtype))
        rows_k, vals_k, u_k, t_k, k_e = rows, vals, u, t, k_of_entry
        K = int(k_of_slot.max()) + 1

    # roll mode: per-slot diagonal offset (constant by construction)
    mode_u = None
    if kernel_mode == "roll":
        mode_u = np.zeros(T * K, np.int64)
        mode_u[slot_t * K + k_of_slot] = slot_d - (slot_wid << wlog)

    plan_out = _assemble(vals_k, rows_k, u_k, t_k, k_e, K, n, m, nnz, wlog,
                         spill=spill,
                         slot_info=(slot_t, slot_wid, k_of_slot),
                         kernel_mode=kernel_mode, mode_u=mode_u)
    return _finish(plan_out)


def _rounded_to_bf16(plan: dict) -> dict:
    """`plan` with its values rounded to bfloat16 (`csr_to_wjd_plan`'s
    ``values_dtype="bfloat16"``). As the JAX planner: an empty slot plan
    (no entries in slots or spill) keeps its values' dtype, its planes
    being zeros, and only its DIA part is rounded."""
    slots = int(plan["nnz"]) > 0
    out = dict(plan)
    for key in (("data", "spill_val", "dia_data") if slots
                else ("dia_data",)):
        if out.get(key) is not None:
            out[key] = _round_to_bf16(out[key])
    if slots:
        out["value_dtype"] = "bfloat16"
    return out


# x-plane size above which the JAX planner sizes groups for its windowed
# TPU kernels and above which those kernels run (`windowed`). Kept so the
# plans (group, Tp) and the choice of kernel stay equal; it is the
# reference's rule, not a statement about Hopper's memory.
X_VMEM_BUDGET = 12 << 20


def _auto_group(K: int) -> int:
    """Tiles per TPU grid step (pads Tp to a multiple of it)."""
    return max(1, min(8, 256 // max(K, 1)))


def _auto_group_windowed(K: int) -> int:
    """Tiles per TPU grid step in the windowed regime."""
    return max(_auto_group(K), min(64, max(8, 512 // max(K, 1))))


def _assemble(vals_k, rows_k, u_k, t_k, k_e, K, n, m, nnz, wlog,
              *, spill, slot_info=None, kernel_mode="gather", mode_u=None):
    win = 1 << wlog
    nj = win // 128 + 1
    group = _auto_group(K)
    if int(m) * 4 > X_VMEM_BUDGET:
        group = _auto_group_windowed(K)
    T = max(1, -(-n // TILE))
    Tp = -(-T // group) * group

    dtype = vals_k.dtype if vals_k.size else np.asarray(spill[2]).dtype
    udtype = np.uint8 if win <= 256 else np.int16
    val_arr = np.zeros((Tp, K, 8, 128) + vals_k.shape[1:], dtype=dtype)
    u_arr = np.zeros((Tp, K, 8, 128), dtype=np.int32)
    brow_arr = np.zeros((Tp, K), dtype=np.int64)
    diag_arr = np.full((Tp, K), -1, dtype=np.int32)

    if slot_info is not None and len(vals_k):
        slot_t, slot_wid, k_of_slot = slot_info
        # flat position of each entry in the (Tp, K, 8, 128) planes: its
        # slot, then its row within the tile (sublane s, lane l)
        flat = (t_k * K + k_e) * TILE + (rows_k & (TILE - 1))
        val_arr.reshape((-1,) + vals_k.shape[1:])[flat] = vals_k

        b = slot_t * TILE + (slot_wid << wlog)       # 128-aligned, may be <0
        pad_lo = int(max(0, -(b.min())))
        pad_lo = -(-pad_lo // 128) * 128
        brow_arr[slot_t, k_of_slot] = (b + pad_lo) >> 7

        u_k32 = u_k.astype(np.int32)
        if kernel_mode == "roll":
            # every slot was forced to one u at conversion: diag_u = that
            # offset (0 for empty slots, whose values are all zero)
            diag_arr = np.zeros((Tp, K), np.int32)
            if mode_u is not None:
                mu = mode_u.reshape(-1, K)[: Tp]
                diag_arr[: mu.shape[0]] = mu.astype(np.int32)
            hole = diag_arr
        else:
            # diagonal slots: every REAL entry shares one u -> pad holes
            # with it (the extremes of u over each slot's entries)
            slot = flat // TILE
            u_max = np.full(Tp * K, -1, np.int32)
            np.maximum.at(u_max, slot, u_k32)
            u_min_real = np.full(Tp * K, win, np.int32)
            np.minimum.at(u_min_real, slot, u_k32)
            u_max, u_min_real = u_max.reshape(Tp, K), u_min_real.reshape(
                Tp, K)
            is_diag = (u_max == u_min_real) & (u_max >= 0)
            diag_arr = np.where(is_diag, u_max, -1).astype(np.int32)
            hole = np.where(is_diag, np.maximum(u_max, 0), 0)
        # a hole takes its slot's fill, an entry its own u
        u_arr = np.repeat(hole.astype(np.int32).reshape(-1), TILE).reshape(
            Tp, K, 8, 128)
        u_arr.reshape(-1)[flat] = u_k32

        max_brow = int(brow_arr.max())

        # per-step x windows: window base = min REAL brow in the step;
        # empty slots are re-based to it so their loads stay inside
        nsteps = Tp // group
        real = np.zeros((Tp, K), dtype=bool)
        real[slot_t, k_of_slot] = True
        b3 = brow_arr.reshape(nsteps, group, K)
        r3 = real.reshape(nsteps, group, K)
        BIG = np.int64(1) << 40
        bmin = np.where(r3, b3, BIG).reshape(nsteps, -1).min(axis=1)
        bsup = np.where(r3, b3, -1).reshape(nsteps, -1).max(axis=1)
        empty_step = bmin >= BIG
        bmin = np.where(empty_step, 0, bmin)
        bsup = np.maximum(bsup, bmin)
        brow_arr = np.where(
            r3, b3, bmin[:, None, None]).reshape(Tp, K)
        win_base = bmin.astype(np.int32)
        load_need_w = _load_rows(nj) + (8 if kernel_mode == "roll" else 0)
        win_rows = int((bsup - bmin).max()) + load_need_w
        win_rows = -(-win_rows // 8) * 8 + 8
    else:
        pad_lo = 0
        max_brow = 0
        win_base = None
        win_rows = 0
        real = np.zeros((Tp, K), dtype=bool)

    # padded x must cover the deepest window load
    load_need = _load_rows(nj) + (8 if kernel_mode == "roll" else 0)
    need_rows = max_brow + load_need
    if win_base is not None and len(win_base):
        need_rows = max(need_rows, int(win_base.max()) + win_rows)
    xp_len = max(need_rows * 128, -(-(pad_lo + m) // 128) * 128)
    sr, sc, sv = spill

    return dict(
        data=val_arr,
        uloc=None if kernel_mode == "roll" else u_arr.astype(udtype),
        brow=brow_arr.astype(np.int32),
        diag_u=diag_arr,
        win_base=win_base,
        win_rows=int(win_rows),
        real=real,
        dia_data=None,
        dia_offsets=(),
        spill_row=np.asarray(sr, dtype=np.int32),
        spill_col=np.asarray(sc, dtype=np.int32),
        spill_val=np.asarray(sv),
        shape=(n, m),
        pad_lo=int(pad_lo),
        xp_len=int(xp_len),
        nnz=int(nnz),
        group=int(group),
        wlog=int(wlog),
        value_dtype=np.dtype(dtype).name,
        kernel_mode=kernel_mode,
    )


def _slot_reach(plan: dict):
    """(brow, u_lo, u_hi) as (Tp, K) int64: each slot's base row and the
    extremes of its local offsets u."""
    brow = np.asarray(plan["brow"], np.int64)
    mode = plan["kernel_mode"]
    if mode == "roll":
        u_lo = u_hi = np.asarray(plan["diag_u"], np.int64)
    elif mode == "gather":
        if plan.get("uloc") is None or plan["uloc"].size != brow.size * TILE:
            raise ValueError("gather-mode WJD plan needs a (Tp, K, 8, 128) "
                             "uloc plane")
        u = np.asarray(plan["uloc"]).reshape(brow.shape + (TILE,))
        u_lo, u_hi = u.min(axis=2).astype(np.int64), u.max(axis=2).astype(
            np.int64)
    else:
        raise ValueError(f"unknown WJD kernel mode {mode!r}")
    return brow, u_lo, u_hi


def _check_x_reach(plan: dict, reach) -> None:
    """Raise ValueError unless every slot load (brow + s)*128 + l + u lies
    in [0, xp_len): the CUDA kernels read x without bounds checks."""
    brow, u_lo, u_hi = reach
    lowest = int((brow * 128 + u_lo).min())
    deepest = int(((brow + 7) * 128 + 127 + u_hi).max())
    if lowest < 0 or deepest >= int(plan["xp_len"]):
        raise ValueError(f"bad WJD plan: slot loads reach x[{lowest}] .. "
                         f"x[{deepest}], outside xp_len={plan['xp_len']}")


def _check_windows(plan: dict, reach) -> None:
    """Raise ValueError unless every slot of grid step i reads x only
    inside the step's window, rows [win_base[i], win_base[i] + win_rows):
    0 <= brow - win_base[i], brow - win_base[i] + load rows <= win_rows
    (the planner's invariants, empty slots included: they are re-based to
    the window), every load offset inside [0, win_rows*128), and the last
    window inside padded x. The windowed kernels rely on it."""
    brow, u_lo, u_hi = reach
    wb = np.asarray(plan["win_base"], np.int64)
    win_rows, group = int(plan["win_rows"]), int(plan["group"])
    Tp, K = brow.shape
    if group <= 0 or Tp % group or wb.shape != (Tp // group,):
        raise ValueError(f"bad WJD plan: win_base {wb.shape} does not match "
                         f"Tp={Tp} tiles in groups of {group}")
    local = brow.reshape(-1, group * K) - wb[:, None]     # (nsteps, group*K)
    nj = (1 << int(plan["wlog"])) // 128 + 1
    load = _load_rows(nj) + (8 if plan["kernel_mode"] == "roll" else 0)
    lo = local * 128 + u_lo.reshape(local.shape)
    hi = (local + 7) * 128 + 127 + u_hi.reshape(local.shape)
    if (int(local.min()) < 0 or int(local.max()) + load > win_rows
            or int(lo.min()) < 0 or int(hi.max()) >= win_rows * 128):
        raise ValueError(
            f"bad WJD plan: slot base rows {int(local.min())} .. "
            f"{int(local.max())} (+{load} load rows) leave the step window "
            f"of win_rows={win_rows}")
    if int(wb.min()) < 0 or (int(wb.max()) + win_rows) * 128 > int(
            plan["xp_len"]):
        raise ValueError(
            f"bad WJD plan: window rows {int(wb.min())} .. "
            f"{int(wb.max()) + win_rows} pass xp_len={plan['xp_len']}")


def compact_slices(plan: dict, window_relative: bool = False) -> dict:
    """Row-compacted slice form of a gather-mode plan (module docstring),
    from the plan's padded planes: numpy arrays ``cval``, ``coff``,
    ``slice_ptr``, ``xbase``. The real entries are the nonzero slot values
    (a stored zero adds nothing to a product and is dropped, as in
    `to_csr`). With `window_relative` the base of a slice is its grid
    step's window, win_base[step]*128, instead of the slice's lowest
    offset. Vectorised: one pass over the planes, then work per entry."""
    brow = np.asarray(plan["brow"], np.int64)
    Tp, K = brow.shape
    data = np.asarray(plan["data"]).reshape(Tp, K, TILE)
    occ = data != 0
    # rank of an entry among its row's entries, in ascending slot order
    upto = np.cumsum(occ, axis=1, dtype=np.uint8 if K < 256 else np.int32)
    width = upto[:, -1, :].reshape(Tp * (TILE // SLICE), SLICE).max(axis=1)
    slice_ptr = np.zeros(len(width) + 1, np.int64)
    np.cumsum(width.astype(np.int64) * SLICE, out=slice_ptr[1:])
    total = int(slice_ptr[-1])

    e = np.flatnonzero(occ.reshape(-1))
    tk, r = e >> 10, e & (TILE - 1)
    row = (tk // K) * TILE + r
    sl = row // SLICE
    pos = slice_ptr[sl] + (upto.reshape(-1)[e].astype(np.int64) - 1) * SLICE \
        + (r & (SLICE - 1))
    del upto, occ
    # offset into padded x: (brow + s)*128 + l + u, and s*128 + l = r
    xoff = brow.reshape(-1)[tk] * 128 + r + np.asarray(
        plan["uloc"]).reshape(-1)[e].astype(np.int64)

    cval = np.zeros(total, data.dtype)
    cval[pos] = data.reshape(-1)[e]
    BIG = np.int64(1) << 62
    off = np.full(total, BIG, np.int64)
    off[pos] = xoff
    if window_relative:
        xbase = np.repeat(np.asarray(plan["win_base"], np.int64) * 128,
                          int(plan["group"]) * (TILE // SLICE))
    else:
        xbase = np.zeros(len(width), np.int64)
        full = width > 0
        if total:
            xbase[full] = np.minimum.reduceat(off, slice_ptr[:-1][full])
    off -= np.repeat(xbase, width.astype(np.int64) * SLICE)
    off[cval == 0] = 0                                 # padding of short rows
    if int(off.min(initial=0)) < 0:       # before the cast to an unsigned type
        raise ValueError(f"bad WJD plan: a compact load lies "
                         f"{-int(off.min())} elements below its step window")
    span = int(off.max(initial=0))
    if span >= 1 << 31:
        raise ValueError(f"bad WJD plan: a slice spans {span} elements of x")
    return dict(cval=cval,
                coff=off.astype(np.uint16 if span < 1 << 16 else np.int32),
                slice_ptr=slice_ptr, xbase=xbase,
                window_relative=bool(window_relative))


def compact_entries(cval, coff, slice_ptr, xbase):
    """(rows, offsets into padded x, values) of the real entries of a
    compact slice form given as numpy arrays: element p of slice i belongs
    to row i*32 + p % 32 (every slice starts at a multiple of 32)."""
    p = np.flatnonzero(cval)
    sl = np.searchsorted(slice_ptr, p, side="right") - 1
    return (sl * SLICE + p % SLICE, xbase[sl] + coff[p].astype(np.int64),
            cval[p])


def pack_bf16_slices(compact: dict) -> dict:
    """The packed form (module docstring) of the compact slice form of a
    bfloat16 plan whose offsets lie below 2**24 (uint16, or int32 below
    PACK_REACH), direct or window-relative: numpy arrays ``cpack`` (uint32
    words, the value's bfloat16 bits | the offset's low 16 bits << 16),
    ``slice_ptr`` (in words) and ``xbase`` (the compact form's, so a
    window-relative form keeps its step windows), and, where an offset
    passes 16 bits, ``chi`` (uint8, the offset's bits 16-23 at the word's
    own index, padding words 0). A row's terms keep their ranks, so a row
    sums the same terms in the same order, plus up to 3 zero words. The
    values are the plan's host form of bfloat16 (f32 arrays holding
    bfloat16 values), whose low 16 bits are zero."""
    cval, coff, ptr = compact["cval"], compact["coff"], compact["slice_ptr"]
    if cval.dtype != np.float32 or coff.dtype not in (np.uint16, np.int32):
        raise ValueError(f"the packed form takes f32-held bfloat16 values "
                         f"and uint16 or int32 offsets, got {cval.dtype}, "
                         f"{coff.dtype}")
    lo, hi = int(coff.min(initial=0)), int(coff.max(initial=0))
    if lo < 0 or hi >= PACK_REACH:
        raise ValueError(f"the packed form holds offsets in [0, 2**24), got "
                         f"{lo} .. {hi}")
    bits = np.ascontiguousarray(cval).view(np.uint32)
    if (bits & 0xFFFF).any():
        raise ValueError("the packed form takes values that bfloat16 holds")
    width = np.diff(ptr) // SLICE
    pptr = np.zeros_like(ptr)
    np.cumsum(-(-width // PACK) * (PACK * SLICE), out=pptr[1:])
    # rank j of a slice (a row of 32 lanes) goes to rank row j of its
    # padded slice; then each group of 4 rank rows is transposed, so that
    # word (j, lane) lies at (j // 4)*128 + lane*4 + j % 4
    j = np.arange(len(cval) // SLICE, dtype=np.int64) - np.repeat(
        ptr[:-1] // SLICE, width)
    at = np.repeat(pptr[:-1] // SLICE, width) + j
    rows = int(pptr[-1]) // SLICE

    def lay(words, dtype):
        ranks = np.zeros((rows, SLICE), dtype)
        ranks[at] = words.reshape(-1, SLICE)
        return ranks.reshape(-1, PACK, SLICE).transpose(0, 2, 1).reshape(-1)

    off = coff.astype(np.uint32)
    out = dict(cpack=lay((bits >> 16) | (off << 16), np.uint32),
               slice_ptr=pptr, xbase=compact["xbase"])
    if hi >= 1 << 16:
        out["chi"] = lay((off >> 16).astype(np.uint8), np.uint8)
    return out


def _rank_rows(words):
    """The words (or high bytes) of a packed form, each rank a row of 32
    lanes, rank-major as in the compact form: a slice is whole groups of
    128, each 4 ranks of 32 lanes stored lane-major, so one transpose."""
    return np.ascontiguousarray(np.asarray(words).reshape(
        -1, SLICE, PACK).transpose(0, 2, 1)).reshape(-1, SLICE)


def unpack_bf16_slices(cpack, slice_ptr, xbase, chi=None) -> dict:
    """The compact slice form (``cval`` as f32-held bfloat16 values,
    ``coff``, ``slice_ptr``, ``xbase``) that `pack_bf16_slices` packed,
    from numpy arrays of the packed form: ``coff`` uint16, or int32 where
    the form carries its high bytes `chi`. A slice's width is its highest
    rank with a nonzero value plus one (the compact form stores nonzero
    values only, and its longest row fills its last rank), and its
    padding ranks are dropped."""
    ranks = _rank_rows(np.asarray(cpack).view(np.uint32))
    pptr = np.asarray(slice_ptr, np.int64)
    rptr = pptr // SLICE                    # rank rows, padding included
    per = np.diff(rptr)
    j = np.arange(len(ranks), dtype=np.int64) - np.repeat(rptr[:-1], per)
    width = np.zeros(len(per), np.int64)
    full = per > 0
    if full.any():
        width[full] = np.maximum.reduceat(
            np.where((ranks & 0xFFFF).any(axis=1), j + 1, 0),
            rptr[:-1][full])
    keep = j < np.repeat(width, per)
    rows = ranks[keep].reshape(-1)
    coff = (rows >> 16).astype(np.uint16)
    if chi is not None:
        coff = coff.astype(np.int32) | (_rank_rows(np.asarray(
            chi, np.uint8))[keep].reshape(-1).astype(np.int32) << 16)
    ptr = np.zeros_like(pptr)
    np.cumsum(width * SLICE, out=ptr[1:])
    return dict(cval=(rows << 16).view(np.float32), coff=coff,
                slice_ptr=ptr, xbase=np.asarray(xbase, np.int64))


def _packs(plan: dict, compact: dict) -> bool:
    """Does this plan take the packed form (with its high bytes where an
    offset passes 16 bits)? A bfloat16 plan whose compact offsets lie
    below 2**24, direct or window-relative: the offset width alone
    decides (module docstring)."""
    coff = compact["coff"]
    return (plan.get("value_dtype") == "bfloat16"
            and (coff.dtype == np.uint16
                 or int(coff.max(initial=0)) < PACK_REACH))


def _form_offsets(compact: dict) -> np.ndarray:
    """The offsets of a compact form, or of a packed one: a word's high
    half, with its high byte where the form carries ``chi``."""
    if "cpack" not in compact:
        return compact["coff"]
    off = compact["cpack"] >> 16
    chi = compact.get("chi")
    return off if chi is None else off | chi.astype(np.uint32) << 16


def _check_compact_reach(compact: dict, xp_len: int) -> None:
    """Raise ValueError unless every load xbase[slice] + offset of the
    compact or the packed form lies in [0, xp_len): the CUDA kernels read
    x without bounds checks."""
    ptr, xbase = compact["slice_ptr"], compact["xbase"]
    off = _form_offsets(compact)
    if not len(off):
        return
    full = np.diff(ptr) > 0
    off, starts = off.astype(np.int64), ptr[:-1][full]
    lowest = int((xbase[full] + np.minimum.reduceat(off, starts)).min())
    deepest = int((xbase[full] + np.maximum.reduceat(off, starts)).max())
    if lowest < 0 or deepest >= int(xp_len):
        raise ValueError(f"bad WJD plan: compact loads reach x[{lowest}] .. "
                         f"x[{deepest}], outside xp_len={xp_len}")


def _check_compact_windows(compact: dict, plan: dict) -> None:
    """The compact twin of `_check_windows`, for a window-relative compact
    or packed form (`_form_offsets`): raise ValueError unless the base of
    every slice of grid step i is win_base[i]*128, every offset lies in
    [0, win_rows*128), and the last window ends inside padded x. The
    windowed gather kernels read x from the step's window without bounds
    checks."""
    wb = np.asarray(plan["win_base"], np.int64)
    win_rows, group = int(plan["win_rows"]), int(plan["group"])
    per_step = group * (TILE // SLICE)
    xbase = compact["xbase"]
    off = _form_offsets(compact)
    if (group <= 0 or xbase.shape != (len(wb) * per_step,)
            or not np.array_equal(xbase, np.repeat(wb * 128, per_step))):
        raise ValueError("bad WJD plan: the compact slice bases are not the "
                         f"step windows of {len(wb)} steps of {group} tiles")
    lo, hi = int(off.min(initial=0)), int(off.max(initial=0))
    if win_rows <= 0 or lo < 0 or hi >= win_rows * 128:
        raise ValueError(f"bad WJD plan: compact loads {lo} .. {hi} leave "
                         f"the step window of win_rows={win_rows}")
    if len(wb) and (int(wb.min()) < 0 or (int(wb.max()) + win_rows) * 128
                    > int(plan["xp_len"])):
        raise ValueError(
            f"bad WJD plan: window rows {int(wb.min())} .. "
            f"{int(wb.max()) + win_rows} pass xp_len={plan['xp_len']}")


def windowed(A: WJD, dtype: torch.dtype) -> bool:
    """Does an x of `dtype` take the windowed kernels on this plan? The JAX
    package's rule for which kernel runs: the padded x plane passes
    X_VMEM_BUDGET and the plan carries windows; gather mode has a windowed
    kernel for an f32 x only (f32 or bfloat16 values), so gather-mode f64
    stays on the direct kernel. A bfloat16 x is widened to f32 before the
    rule is read (ops/cuda/spmv_wjd.py), so it takes an f32 x's kernel. For
    a gather plan the rule was applied when its compact form was built
    (`_plan_to_wjd`), and `window_relative` holds the answer: the layout
    and the kernel that reads it cannot disagree."""
    if A.kernel_mode == "gather":
        return A.window_relative
    return _window_regime(A.win_base is not None, A.xp_len, A.kernel_mode,
                          dtype.itemsize, dtype == torch.float32)


def _window_regime(has_windows, xp_len, mode, itemsize, is_f32) -> bool:
    if not has_windows or xp_len * itemsize <= X_VMEM_BUDGET:
        return False
    return mode == "roll" or is_f32


# the value arrays of a plan: bfloat16 on the WJD of a bfloat16 plan
_VALUES = ("data", "cval", "spill_val", "dia_data")


def _plan_to_wjd(plan: dict, device) -> WJD:
    """Materialize a host plan as a WJD on ``device`` (one upload per
    array), after checking that no slot load leaves padded x or, where
    the plan has per-step windows, its step's window. A gather-mode plan
    is compacted here (`compact_slices`), window-relative where the
    windowed gather kernel will serve it, packed where it is a bfloat16
    plan with offsets below 2**24 (`pack_bf16_slices`, with its high bytes
    where an offset passes 16 bits), and its form is checked
    against padded x and its step windows; its padded planes go along only
    to the CPU."""
    if np.asarray(plan["brow"]).size:
        reach = _slot_reach(plan)
        _check_x_reach(plan, reach)
        if plan.get("win_base") is not None:
            _check_windows(plan, reach)
    skip = ()
    bf16 = plan.get("value_dtype") == "bfloat16"
    if plan["kernel_mode"] == "gather":
        # the regime follows x, whose dtype is the host values': f32 for a
        # bfloat16 plan too, whose values are f32 on the host
        vdt = np.asarray(plan["data"]).dtype
        compact = compact_slices(plan, window_relative=_window_regime(
            plan.get("win_base") is not None, int(plan["xp_len"]), "gather",
            vdt.itemsize, vdt == np.float32))
        if _packs(plan, compact):
            compact = {**compact, **pack_bf16_slices(compact),
                       "cval": None, "coff": None}
        if compact["window_relative"]:
            _check_compact_windows(compact, plan)
        _check_compact_reach(compact, plan["xp_len"])
        plan = {**plan, **compact}
        if torch.device(device).type != "cpu":
            skip = ("data", "uloc")

    def put(name, dt=None):
        a = plan.get(name)
        if a is None or name in skip:
            return None
        t = to_device(a, device, dt)
        return t.to(torch.bfloat16) if bf16 and name in _VALUES else t

    return WJD(
        cval=put("cval"),
        coff=put("coff"),
        cpack=(None if plan.get("cpack") is None
               else to_device(plan["cpack"].view(np.int32), device)),
        chi=(None if plan.get("chi") is None
             else to_device(plan["chi"], device)),
        slice_ptr=put("slice_ptr", np.int64),
        xbase=put("xbase", np.int64),
        window_relative=bool(plan.get("window_relative", False)),
        data=put("data"),
        uloc=put("uloc"),
        brow=put("brow", np.int32),
        diag_u=put("diag_u", np.int32),
        win_base=put("win_base", np.int32),
        win_rows=int(plan.get("win_rows", 0)),
        dia_data=put("dia_data"),
        dia_offsets=tuple(plan.get("dia_offsets", ())),
        spill_row=put("spill_row", np.int32),
        spill_col=put("spill_col", np.int32),
        spill_val=put("spill_val"),
        shape=tuple(plan["shape"]),
        pad_lo=int(plan["pad_lo"]),
        xp_len=int(plan["xp_len"]),
        nnz=int(plan["nnz"]),
        group=int(plan["group"]),
        wlog=int(plan["wlog"]),
        kernel_mode=plan["kernel_mode"],
    )


@dataclasses.dataclass(frozen=True)
class ComplexWJD(MatrixBase):
    """A complex operator as two real WJD planes on one pattern, its real
    part `re` and its imaginary part `im` (the reference's c/z csrmv,
    hip_sparse.hpp rocsparseCcsrmv/Zcsrmv):
    y = (Ar xr - Ai xi) + i (Ar xi + Ai xr). complex64 values ride f32
    planes, complex128 values f64 planes (ops/cuda/spmv_wjd.py:
    `cwjd_spmv`). Each plane is the plan of its part alone, so they share
    the layout; a gather-mode plane's compact form drops its own zeros."""

    re: WJD
    im: WJD
    value_dtype: str         # numpy name of the values' type

    @property
    def shape(self) -> Tuple[int, int]:
        return self.re.shape

    @property
    def nnz(self) -> int:
        return self.re.nnz

    @property
    def dtype(self) -> torch.dtype:
        return (torch.complex64 if self.value_dtype == "complex64"
                else torch.complex128)

    @property
    def device(self) -> torch.device:
        return self.re.device


def _plane(plan: dict, j: int) -> dict:
    """The plan of value plane j of a plan made from (nnz, P) values."""
    out = dict(plan)
    for key in ("data", "spill_val", "dia_data"):
        if plan.get(key) is not None:
            out[key] = np.ascontiguousarray(plan[key][..., j])
    return out


def from_csr(A, device=None, **kwargs):
    """Convert a host-built CSR to WJD on ``device`` (default: A's): plan
    on the host (kwargs go to `csr_to_wjd_plan`), then upload once. A
    complex CSR gives a `ComplexWJD`: its real and imaginary parts are
    planned together (the layout once, two value planes), as the real
    type of the values."""
    d, i, p = A.numpy_triplet()
    device = A.device if device is None else device
    if np.iscomplexobj(d):
        real_dt = np.float64 if d.dtype == np.complex128 else np.float32
        plan = csr_to_wjd_plan(np.stack([d.real, d.imag], axis=1).astype(
            real_dt), i, p, A.shape, **kwargs)
        return ComplexWJD(re=_plan_to_wjd(_plane(plan, 0), device),
                          im=_plan_to_wjd(_plane(plan, 1), device),
                          value_dtype=np.dtype(d.dtype).name)
    return _plan_to_wjd(csr_to_wjd_plan(d, i, p, A.shape, **kwargs),
                        device=device)


def stack_wjd_plan(parts, shape, *, wlog=None,
                   max_slots: Optional[int] = 128) -> dict:
    """Host plan of P same-shape CSR triplets with their static fields
    unified, the arrays of the JAX package's `stack_wjd` (its
    formats/wjd.py) with a leading (P,) axis: one kernel shape serves
    every part of a distributed operator's interior. Part 0's auto choice
    fixes ``wlog`` and the kernel mode for every part; K, pad_lo, xp_len
    and the spill length are the parts' maxima; an x plane of more than
    X_VMEM_BUDGET bytes in f32 (``m * 4``) gives the windowed grouping
    and per-step windows on that unified grouping. f64 values are one
    native plane (module docstring). ``part_nnz`` holds each part's own
    entry count; ``nnz`` is their sum, as in the JAX package."""
    ws = []
    wl = wlog
    kmode = None
    for (v, c, p) in parts:
        w = csr_to_wjd_plan(v, c, p, shape,
                            wlog=(wl if wl is not None else "auto"),
                            max_slots=max_slots,
                            kernel_mode=(kmode or "auto"),
                            split_dia=False)
        if wl is None:
            wl = w["wlog"]
        if kmode is None:
            kmode = w["kernel_mode"]   # part 0 decides for every part
        ws.append(w)

    P = len(ws)
    n, m = int(shape[0]), int(shape[1])
    K = max(w["brow"].shape[1] for w in ws)
    windowed_x = int(m) * 4 > X_VMEM_BUDGET
    group = _auto_group_windowed(K) if windowed_x else _auto_group(K)
    T = max(1, -(-n // TILE))
    Tp = -(-T // group) * group
    pad_lo = -(-max(w["pad_lo"] for w in ws) // 128) * 128
    nj = (1 << wl) // 128 + 1
    load_need = _load_rows(nj) + (8 if kmode == "roll" else 0)
    xp_len = max(
        max((int(w["brow"].max()) + (pad_lo - w["pad_lo"]) // 128
             + load_need) * 128 for w in ws),
        -(-(pad_lo + m) // 128) * 128,
    )
    nspill = max(w["spill_row"].shape[0] for w in ws)
    vdtype = ws[0]["data"].dtype

    def alloc(shp, dtype, fill=0):
        return np.full((P,) + shp, fill, dtype=dtype)

    data = alloc((Tp, K, 8, 128), vdtype)
    uloc = (None if ws[0]["uloc"] is None
            else alloc((Tp, K, 8, 128), ws[0]["uloc"].dtype))
    brow = alloc((Tp, K), np.int64)
    real = alloc((Tp, K), bool)
    # roll mode reads diag_u unconditionally: pad slots must be 0, not -1
    diag = alloc((Tp, K), np.int32, fill=(0 if kmode == "roll" else -1))
    sr = alloc((nspill,), np.int32)
    sc = alloc((nspill,), np.int32)
    sv = alloc((nspill,), ws[0]["spill_val"].dtype)

    for q, w in enumerate(ws):
        Tq, Kq = w["brow"].shape
        tq = min(Tq, Tp)
        data[q, :tq, :Kq] = w["data"][:tq]
        if uloc is not None:
            uloc[q, :tq, :Kq] = w["uloc"][:tq]
        brow[q, :tq, :Kq] = (w["brow"][:tq]
                             + (pad_lo - w["pad_lo"]) // 128)
        real[q, :tq, :Kq] = w["real"][:tq]
        diag[q, :tq, :Kq] = w["diag_u"][:tq]
        ns = w["spill_row"].shape[0]
        if ns:
            sr[q, :ns] = w["spill_row"]
            sc[q, :ns] = w["spill_col"]
            sv[q, :ns] = w["spill_val"]

    # per-step windows on the UNIFIED grouping (each part's own plan used
    # its own group and Tp): the base is the lowest real brow of the step,
    # the other slots are re-based onto it, and win_rows is the widest
    # span over all parts
    win_base = None
    win_rows = 0
    if windowed_x:
        nsteps = Tp // group
        b3 = brow.reshape(P, nsteps, group * K)
        r3 = real.reshape(P, nsteps, group * K)
        BIG = np.int64(1) << 40
        bmin = np.where(r3, b3, BIG).min(axis=2)
        bsup = np.where(r3, b3, -1).max(axis=2)
        empty = bmin >= BIG
        bmin = np.where(empty, 0, bmin)
        bsup = np.maximum(bsup, bmin)
        brow = np.where(r3, b3, bmin[:, :, None]).reshape(P, Tp, K)
        win_base = bmin.astype(np.int32)
        win_rows = int((bsup - bmin).max()) + load_need
        win_rows = -(-win_rows // 8) * 8 + 8
        xp_len = max(xp_len, (int(win_base.max()) + win_rows) * 128)

    return dict(
        data=data, uloc=uloc, brow=brow.astype(np.int32), diag_u=diag,
        win_base=win_base, win_rows=int(win_rows),
        spill_row=sr, spill_col=sc, spill_val=sv,
        shape=(n, m), pad_lo=int(pad_lo), xp_len=int(xp_len),
        nnz=int(sum(w["nnz"] for w in ws)),
        part_nnz=tuple(int(w["nnz"]) for w in ws),
        group=int(group), wlog=int(wl),
        value_dtype=ws[0]["value_dtype"], kernel_mode=kmode or "gather",
    )


@dataclasses.dataclass(frozen=True)
class StackedWJD:
    """The per-part WJD plans of a distributed operator's interior, with
    the static fields unified across parts (`stack_wjd_plan`). Part q is
    an ordinary WJD of its own (`shard_of`), so the interior apply
    launches the serial entry point once per part, as `shard_map` runs
    the JAX kernel once per shard. A gather-mode part on the card carries
    its own compact slice form (window-relative where the plan is
    windowed). `stacked(name)` gives an array with the leading (P,) axis
    of the JAX package's stacked WJD."""

    parts: Tuple[WJD, ...]

    @property
    def nparts(self) -> int:
        return len(self.parts)

    @property
    def kernel_mode(self) -> str:
        return self.parts[0].kernel_mode

    @property
    def nnz(self) -> int:
        return sum(w.nnz for w in self.parts)

    def stacked(self, name: str) -> Optional[torch.Tensor]:
        """Field `name` of every part stacked on a new leading axis."""
        got = [getattr(w, name) for w in self.parts]
        return None if got[0] is None else torch.stack(got)


def _part_plan(plan: dict, q: int) -> dict:
    """The plan of part q of a stacked plan: its arrays, the unified
    static fields and its own entry count."""
    out = {k: plan[k] for k in ("win_rows", "shape", "pad_lo", "xp_len",
                                "group", "wlog", "value_dtype",
                                "kernel_mode")}
    for k in ("data", "uloc", "brow", "diag_u", "win_base", "spill_row",
              "spill_col", "spill_val"):
        out[k] = None if plan.get(k) is None else plan[k][q]
    out["nnz"] = int(plan["part_nnz"][q])
    out["dia_data"], out["dia_offsets"] = None, ()
    return out


def stacked_from_plan(plan: dict, device) -> StackedWJD:
    """Materialize a stacked host plan part by part (`_plan_to_wjd`: the
    reach and window checks, compacting, one upload per array)."""
    return StackedWJD(tuple(_plan_to_wjd(_part_plan(plan, q), device)
                            for q in range(plan["brow"].shape[0])))


def stack_wjd(parts, shape, *, wlog=None, max_slots: Optional[int] = 128,
              device=None) -> StackedWJD:
    """Plan P same-shape CSR triplets ``(vals, cols, indptr)`` with unified
    static fields (`stack_wjd_plan`) and put the parts on ``device``."""
    from ..config import resolve_device

    return stacked_from_plan(
        stack_wjd_plan(parts, shape, wlog=wlog, max_slots=max_slots),
        resolve_device(device))


def shard_of(W: StackedWJD, q: int = 0) -> WJD:
    """Part q of a stacked plan, as the serial entry points take it."""
    return W.parts[q]
