"""Time the packed24 bf16 kernels beside the kernels they replace and the
design tried beside them, on one NVIDIA GPU.

    python scripts/bf16_wide_variants.py [--direct-n 1048576]
                                         [--win-n 4194304] [--turns 8]
                                         [--wide-band 32768]

Two kinds of plan, each the bf16 plan (the f32 plan with its values
rounded) of an f32 random_banded_spd in gather mode, direct at direct_n
rows and windowed at win_n rows (the default sizes):

  moved    chip_smoke.py phase N1's plans (band +-8192) with their offsets
           moved past 16 bits as N1 moves them (`chip_smoke.widened`: a
           direct slice's base lowered by 65,536 elements, a step's window
           widened by up to 512 rows below): the same product, its gathers
           of x the narrow band's;
  natural  random_banded_spd(n, bandwidth=wide_band): a band of +-32,768
           columns, so that a direct slice spans more than 65,536 elements
           of x and a step's window more than 512 rows, and the planner's
           own plan takes the packed24 form; its gathers spread over the
           wide band.

On each, in one process and on the same x (X of 16 columns for the
blocked products), this times with CUDA events (one warm-up, then `turns`
rounds in alternating order, each the mean of 20 back-to-back launches;
the median is printed):

  spmv  packed, the moved plan before its offsets were moved (16-bit
        offsets, 4 bytes a stored element: the floor of the form);
        packed24, a high byte a word (5 bytes, shipped); a high half a word
        (6 bytes, every int32 offset covered; not shipped, built from the
        package's source with -DWJD_VARIANTS); the packed and packed24
        kernels held to 32 registers so that two blocks fit an SM (the
        compact windowed kernel's shape; -DWJD_VARIANTS); the compact bf16
        kernel on the same plan with int32 offsets (6 bytes: the kernel
        packed24 replaces below 2**24);
  spmm  k = 16: packed (moved plans), packed24 and compact.

Every product is held to the plain version over its form (1e-5,
norm-wise). Prints one line a kernel, the card's name and its power limit.
"""

import argparse
import ctypes
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

COLS = 16


def build_variants(build_dir):
    """The package's packed source with -DWJD_VARIANTS: its SpMVs over a
    high half a word, and its SpMVs held to two blocks an SM, argument
    types set."""
    from rocalution_tpu_torch.ops.cuda import _build

    build_dir.mkdir(parents=True, exist_ok=True)
    lib = build_dir / "libwjd_bf16_packed_wide_variants.so"
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-DWJD_VARIANTS",
                    "-o", str(lib), str(_build.CSRC / "wjd_bf16_packed.cu")],
                   check=True)
    dll = ctypes.CDLL(str(lib))
    P, I64, INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    out = {}
    for key, name, argtypes in (
            ("hi16", "wjd_spmv_gather_bf16_packed_hi16",
             [P, P, P, P, P, P, I64, P]),
            ("win hi16", "wjd_spmv_win_gather_bf16_packed_hi16",
             [P, P, P, P, P, P, I64, INT, P]),
            ("mb2", "wjd_spmv_gather_bf16_packed_mb2",
             [P, P, P, P, P, P, I64, P]),
            ("win mb2", "wjd_spmv_win_gather_bf16_packed_mb2",
             [P, P, P, P, P, P, I64, INT, P])):
        fn = getattr(dll, name)
        fn.argtypes, fn.restype = argtypes, INT
        out[key] = fn
    return out


def bf16_plan(fw, A):
    """A's bf16 plan on the card: its f32 plan with the values rounded."""
    plan32 = fw.csr_to_wjd_plan(*A.numpy_triplet(), A.shape, cache=False)
    return fw._plan_to_wjd(fw._rounded_to_bf16(plan32), "cuda")


def cell(title, A, fw, k, smoke, vs, turns, card, moved):
    """Time the kernels of one operator's bf16 plan (module docstring):
    N1's plan with its offsets moved where `moved`, else the plan as the
    planner gives it."""
    from bf16_win_variants import run

    t0 = time.perf_counter()
    W = bf16_plan(fw, A)
    plan_s = time.perf_counter() - t0
    if moved:
        assert W.compact_form == "packed"
        c, _ = smoke.unpacked(W)
        Ww, _ = smoke.widened(W, c)
    else:
        assert W.compact_form == "packed24", W.compact_form
        c = fw.unpack_bf16_slices(*(t.cpu().numpy() for t in (
            W.cpack, W.slice_ptr, W.xbase, W.chi)))
        W, Ww = None, W
    # the same product on int32 offsets: W's (or the natural plan's)
    Wc, _ = smoke.compact_copy(Ww if W is None else W, c)
    del c
    assert Ww.compact_form == "packed24" and Wc.compact_form == "compact"
    W0 = Ww if W is None else W
    win = fw.windowed(Ww, torch.float32)
    # the high half a word: the packed24 form's high bytes widened
    h16 = Ww.chi.to(torch.int16)
    rng = np.random.default_rng(1234)
    x = torch.from_numpy(rng.standard_normal(A.shape[1]).astype(
        np.float32)).cuda()
    X = torch.from_numpy(rng.standard_normal((A.shape[1], COLS)).astype(
        np.float32)).cuda()
    xp, xpw, xpc = k.pad_x(W0, x), k.pad_x(Ww, x), k.pad_x(Wc, x)
    Xp, Xpw, Xpc = (k.pad_x(V, X, COLS) for V in (W0, Ww, Wc))
    launch = k.slots_kernel_windowed if win else k.slots_kernel
    y = torch.empty(Ww.xbase.numel() * 32, dtype=torch.float32,
                    device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def variant(key, V, hi, xq):
        """Launch variant `key` on plan V with high plane hi (a tensor, or
        None for 16-bit offsets) over padded x xq."""
        def go():
            hp = None if hi is None else hi.data_ptr()
            if win:
                rc = vs["win " + key](V.cpack.data_ptr(), hp,
                                      V.slice_ptr.data_ptr(),
                                      V.win_base.data_ptr(), xq.data_ptr(),
                                      y.data_ptr(), V.win_base.numel(),
                                      V.group * 32, stream)
            else:
                rc = vs[key](V.cpack.data_ptr(), hp, V.slice_ptr.data_ptr(),
                             V.xbase.data_ptr(), xq.data_ptr(), y.data_ptr(),
                             V.xbase.numel(), stream)
            assert rc == 0, rc
            return y
        return go

    plain = k.plain_gather(Ww)(Ww, xpw)
    words = Ww.cpack.numel()
    print(f"{title} -> bf16, {'windowed' if win else 'direct'}, "
          f"{'moved' if moved else 'natural'}: planned in {plan_s:.1f} s, "
          f"nnz={A.nnz}, {words} words ({words / Ww.nnz:.4f} a nonzero), "
          f"compact "
          f"{Wc.cval.numel()} elements; packed24 win_rows={Ww.win_rows}, "
          f"offsets to {int(k._offsets(Ww).max())} | {card}")
    pre = ("win " if win else "") + ("" if moved else "natural ")
    before = {}
    if W is not None:
        plain0 = k.plain_gather(W)(W, xp)
        before = {"packed, 16-bit offsets (the plan before)": (
                      lambda: launch(W, xp), plain0),
                  "packed, two blocks an SM": (variant("mb2", W, None, xp),
                                               plain0)}
    run(f"{pre}spmv", {
        **before,
        "packed24, a high byte a word (shipped)": (
            lambda: launch(Ww, xpw), plain),
        "packed24, two blocks an SM": (variant("mb2", Ww, Ww.chi, xpw),
                                       plain),
        "a high half a word": (variant("hi16", Ww, h16, xpw), plain),
        "compact, int32 offsets": (
            lambda: launch(Wc, xpc), k.plain_gather(Wc)(Wc, xpc))}, turns)
    del plain, before
    mrhs = k.slots_kernel_mrhs
    before = {} if W is None else {
        "packed, 16-bit offsets": (
            lambda: mrhs(W, Xp), k.plain_gather(W, mrhs=True)(W, Xp))}
    run(f"{pre}spmm k={COLS}", {
        **before,
        "packed24 (shipped)": (
            lambda: mrhs(Ww, Xpw), k.plain_gather(Ww, mrhs=True)(Ww, Xpw)),
        "compact, int32 offsets": (
            lambda: mrhs(Wc, Xpc), k.plain_gather(Wc, mrhs=True)(Wc, Xpc))},
        turns)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--direct-n", type=int, default=1 << 20)
    ap.add_argument("--win-n", type=int, default=1 << 22)
    ap.add_argument("--turns", type=int, default=8)
    ap.add_argument("--wide-band", type=int, default=1 << 15)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    import chip_smoke as smoke
    import rocalution_tpu_torch as rt
    from rocalution_tpu_torch.formats import wjd as fw
    from rocalution_tpu_torch.ops.cuda import spmv_wjd as k

    os.environ["ROCALUTION_TPU_TORCH_PLAN_CACHE"] = "0"
    card = smoke.card_line()
    k.build()
    vs = build_variants(ROOT / "rocalution_tpu_torch" / "_build" /
                        "variants")
    for n, band, moved in ((args.direct_n, 8192, True),
                           (args.win_n, 8192, True),
                           (args.direct_n, args.wide_band, False),
                           (args.win_n, args.wide_band, False)):
        A = rt.random_banded_spd(n, bandwidth=band, dtype=np.float32,
                                 device="cpu")
        cell(f"random_banded_spd({n}, bandwidth={band}) f32", A, fw, k,
             smoke, vs, args.turns, card, moved)
        del A
        torch.cuda.empty_cache()
    print(card)


if __name__ == "__main__":
    main()
