"""Port parity: one apply of every preconditioner of the rest of the stack
(GS/SGS/SOR/SSOR, the multicoloured family, ILU(p), ILUT, the BCSR
factorizations, FSAI, SPAI, TNS, AIChebyshev, BlockJacobi, AS/RAS,
MultiElimination, VariablePreconditioner, BlockPreconditioner, the
saddle-point preconditioner) on one r, through the JAX package and the
port on the CPU: rtol 1e-12 in f64. The level schedules, the sweeps and
the batched block products run the JAX package's arithmetic in another
summation order; AS/RAS recombine in two scatter passes, the JAX sum bit
for bit. The cases are grouped a family a test, each family a module of
the JAX package.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import rocalution_tpu as jrt
import rocalution_tpu_torch as rt
from rocalution_tpu import precond as jp
from rocalution_tpu.ops import extract as jax_ext
from rocalution_tpu_torch import precond as tp
from rocalution_tpu_torch.ops import extract
from test_torch_native import natives_loaded  # noqa: F401  (autouse)
from test_torch_native import plan_cache_off  # noqa: F401  (autouse)
from test_torch_precond import _close, on_the_cpu, ops  # noqa: F401


def _bcsr(m, A):
    return m.convert(A, "BCSR", block_dim=2)


APPLIES = {
    "gs": ("lap2d_12", lambda P, m, A: P.gs(A)),
    "backward_gs": ("cd2d_16", lambda P, m, A: P.backward_gs(A)),
    "sgs": ("lap3d_8", lambda P, m, A: P.sgs(A)),
    "sor": ("cd2d_16", lambda P, m, A: P.sor(A, 1.3)),
    "ssor": ("lap3d_8", lambda P, m, A: P.ssor(A, 1.5)),
    "mc_gs": ("cd2d_16", lambda P, m, A: P.multicolored_gs(A)),
    "mc_sgs": ("lap3d_8", lambda P, m, A: P.multicolored_sgs(A)),
    "mc_ilu_0_1": ("lap3d_8", lambda P, m, A: P.multicolored_ilu(A, 0, 1)),
    "mc_ilu_1": ("cd2d_16", lambda P, m, A: P.multicolored_ilu(A, 1)),
    "ilu1": ("cd2d_16", lambda P, m, A: P.ilu(A, 1)),
    "ilu2_jacobi": ("cd2d_16", lambda P, m, A: P.ilu(A, 2, method="jacobi")),
    "ilut": ("cd2d_16", lambda P, m, A: P.ilut_precond(A)),
    "bsr_ilu0": ("cd2d_16", lambda P, m, A: P.bsr_ilu0(_bcsr(m, A))),
    "bsr_ilu0_jacobi": ("cd2d_16", lambda P, m, A: P.bsr_ilu0(
        _bcsr(m, A), method="jacobi")),
    "bsr_ic0": ("lap2d_12", lambda P, m, A: P.bsr_ic0(_bcsr(m, A))),
    "fsai": ("lap3d_8", lambda P, m, A: P.fsai(A)),
    "spai": ("cd2d_16", lambda P, m, A: P.spai(A)),
    "tns": ("lap3d_8", lambda P, m, A: P.tns(A, 3)),
    "aichebyshev": ("lap3d_8", lambda P, m, A: P.aichebyshev(A, 4)),
    "block_jacobi": ("lap2d_12", lambda P, m, A: P.block_jacobi(A, 5)),
    "as": ("lap2d_12", lambda P, m, A: P.additive_schwarz(A, 3, 3)),
    "as_wide_overlap": ("lap2d_12", lambda P, m, A: P.additive_schwarz(
        A, 3, 25)),
    "ras": ("cd2d_16", lambda P, m, A: P.restricted_additive_schwarz(
        A, 4, 4)),
    "me": ("lap2d_12", lambda P, m, A: P.multi_elimination(
        A, 2, 1e-3, last_solver=P.ilu)),
    "variable": ("lap2d_12", lambda P, m, A: P.variable_precond(
        [P.jacobi(A), P.sgs(A), P.tns(A)])),
}

FAMILIES = {
    "gs": ("gs", "backward_gs", "sgs", "sor", "ssor"),
    "multicolored": ("mc_gs", "mc_sgs", "mc_ilu_0_1", "mc_ilu_1"),
    "ilu": ("ilu1", "ilu2_jacobi", "ilut", "bsr_ilu0", "bsr_ilu0_jacobi",
            "bsr_ic0"),
    "ai": ("fsai", "spai", "tns", "aichebyshev"),
    "block": ("block_jacobi", "as", "as_wide_overlap", "ras"),
    "me": ("me", "variable"),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_apply_matches_jax(ops, family):
    r = {}
    for case in FAMILIES[family]:
        name, make = APPLIES[case]
        Aj, At = ops[name]
        Mj, Mt = make(jp, jrt, Aj), make(tp, rt, At)
        if name not in r:
            r[name] = np.random.default_rng(3).standard_normal(At.shape[0])
        for _ in range(3 if case == "variable" else 1):  # every branch once
            _close(Mt(torch.from_numpy(r[name])), Mj(jnp.asarray(r[name])),
                   1e-12)


def test_block_precond_and_as_with_inner_solvers_match_jax(ops):
    Aj, At = ops["cd2d_16"]
    bj = jax_ext.extract_submatrices(Aj, 2)
    bt = extract.extract_submatrices(At, 2)
    r = np.random.default_rng(5).standard_normal(At.shape[0])
    for lower in (False, True):
        Mj = jp.block_precond(Aj, 2, [jp.ilu(bj[i][i]) for i in range(2)],
                              lower=lower)
        Mt = tp.block_precond(At, 2, [tp.ilu(bt[i][i]) for i in range(2)],
                              lower=lower)
        _close(Mt(torch.from_numpy(r)), Mj(jnp.asarray(r)), 1e-12)
    Mj = jp.additive_schwarz(Aj, 2, 6, inner=jp.ilu)
    Mt = tp.additive_schwarz(At, 2, 6, inner=tp.ilu)
    _close(Mt(torch.from_numpy(r)), Mj(jnp.asarray(r)), 1e-12)


def test_saddle_point_apply_matches_jax():
    import scipy.sparse as sp

    A11 = sp.random(40, 40, density=0.1, random_state=1)
    A11 = (A11 + A11.T + 160 * sp.eye(40)).tocsr()
    B = sp.random(40, 12, density=0.2, random_state=2).tocsr()
    K = sp.bmat([[A11, B], [B.T, None]], format="coo")
    Kj = jrt.CSR.from_coo(K.row, K.col, K.data, K.shape)
    Kt = rt.CSR.from_coo(K.row, K.col, K.data, K.shape)
    r = np.random.default_rng(6).standard_normal(52)
    _close(tp.saddle_point_precond(Kt, 40)(torch.from_numpy(r)),
           jp.saddle_point_precond(Kj, 40)(jnp.asarray(r)), 1e-12)


