"""The port's client samples (clients/samples_torch/): all 40 run in this
process through `runpy` on the CPU, at tests/test_clients.py's CI sizes
(POISSON_N=24, 8 virtual devices from tests/conftest.py), grouped into
parametrised tests. Each passes test_clients.py's check (a clean exit,
and status 1/2 or err < 1e-3 where it solves), and prints the iteration
counts that the JAX sample of the same name, clients/samples/<name>.py,
prints when it runs just before it in this process. `multiprocess_cg`
starts two gloo processes on the CPU (its JAX twin two JAX processes).

IDR's shadow space and the power method's start vector are the port's
own host draws; here they are JAX's (`jax_draw`), as in
test_torch_krylov.py, so that those counts can be held exactly.
"""

import os
import re
import runpy
import sys

import jax
import numpy as np
import pytest
import torch

import rocalution_tpu  # turns on JAX's x64, as its samples run
import rocalution_tpu_torch as rt
from test_torch_native import plan_cache_off  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "clients", "samples_torch")
JAX_SAMPLES = os.path.join(ROOT, "clients", "samples")

# Counts that rounding rules: a change of b by one part in 1e15 moves the
# JAX sample's count by more than the port's differs from it. The port's
# count must lie in the range that the JAX sample's counts span under b,
# b * (1 - 1e-15) and b * (1 + 1e-15); the solver each sample calls.
ROUNDING_RULED = {"qmrcgstab": "qmrcgstab"}
B_SCALES = (1.0, 1.0 - 1e-15, 1.0 + 1e-15)

# samples that demonstrate something other than a convergent solve:
# success = clean exit + their own printed check (tests/test_clients.py)
NO_CONVERGENCE_CHECK = {
    "key", "simple_spmv", "power_method", "benchmark", "benchmark_dist",
    "async_transfer", "cmk", "global_io",
    "laplace_2d_weak_scaling", "laplace_3d_weak_scaling",
}

GROUPS = {
    "cg_family": ("cg", "fcg", "complex_solve", "stencil"),
    "nonsymmetric": ("bicgstab", "gmres", "fgmres", "qmrcgstab"),
    "random_starts": ("idr", "power_method", "fixed_point"),
    "factorizations": ("itsolve", "async_transfer", "direct", "cmk"),
    "preconditioners": ("as_precond", "block_precond", "me_preconditioner",
                        "var_precond", "sp_precond", "tns",
                        "mixed_precision"),
    "aggregation_amg": ("amg", "sa_amg", "ua_amg", "cg_amg"),
    "rs_and_large_amg": ("cg_rsamg", "poisson3d_large"),
    "distributed": ("global_cg", "global_io", "global_krylov"),
    "distributed_amg": ("global_cg_amg", "poisson3d_dist"),
    "timing_and_spmv": ("benchmark", "benchmark_dist",
                        "laplace_2d_weak_scaling",
                        "laplace_3d_weak_scaling", "key", "simple_spmv"),
    "multiprocess": ("multiprocess_cg",),
}


@pytest.fixture(autouse=True)
def on_the_cpu(monkeypatch):
    """The CPU, the CI size, and one torch thread: the samples' many small
    ops slow down several-fold when each test worker's threads contend
    for the cores."""
    before = rt.config.default_device(), torch.get_num_threads()
    rt.set_default_device("cpu")
    torch.set_num_threads(1)
    monkeypatch.setenv("POISSON_N", "24")      # test_clients.py's CI size
    monkeypatch.setattr(sys, "path", list(sys.path))
    yield
    rt.set_default_device(before[0])
    torch.set_num_threads(before[1])


@pytest.fixture
def jax_draw(monkeypatch):
    """The port's host normal draws replaced by JAX's draw of the same
    shape and seed."""
    def draw(n, cols, seed):
        return torch.from_numpy(np.asarray(jax.random.normal(
            jax.random.PRNGKey(int(seed)), (n, cols), np.float64)))

    # the package attributes `idr` and `spectral` name other objects
    for mod in ("rocalution_tpu_torch.solvers.krylov.idr",
                "rocalution_tpu_torch.ops.spectral"):
        monkeypatch.setattr(sys.modules[mod], "host_normal", draw)


def _names(d):
    return sorted(f[:-3] for f in os.listdir(d) if f.endswith(".py"))


def _counts(out):
    return [int(v) for v in re.findall(r"iters=(\d+)", out)]


def _run(root, name, monkeypatch, capfd):
    """clients/<root>/<name>.py as `__main__` in this process; what it
    (and any process it starts) printed."""
    path = os.path.join(root, f"{name}.py")
    with monkeypatch.context() as m:
        m.setattr(sys, "argv", [path])
        runpy.run_path(path, run_name="__main__")
    return capfd.readouterr().out


def _jax_counts(name, monkeypatch, capfd):
    """The counts the JAX sample prints here: [] where its source prints
    none; for a rounding-ruled one, a list of the counts it prints under
    each scale of B_SCALES, one list a scale."""
    with open(os.path.join(JAX_SAMPLES, f"{name}.py")) as f:
        if "iters=" not in f.read():
            return []
    if name not in ROUNDING_RULED:
        return _counts(_run(JAX_SAMPLES, name, monkeypatch, capfd))
    solver = getattr(rocalution_tpu, ROUNDING_RULED[name])
    runs = []
    for scale in B_SCALES:
        def scaled(A, b, *args, scale=scale, **kw):
            return solver(A, b * scale, *args, **kw)

        with monkeypatch.context() as m:
            m.setattr(rocalution_tpu, ROUNDING_RULED[name], scaled)
            runs.append(_counts(_run(JAX_SAMPLES, name, monkeypatch,
                                     capfd)))
    return runs


def _check(name, out, want):
    """tests/test_clients.py's check, then the JAX sample's counts."""
    if name not in NO_CONVERGENCE_CHECK:
        errs = re.findall(r"err(?:or)?[=:]\s*([0-9.e+-]+)", out)
        converged = ("status=1" in out or "status=2" in out
                     or "converged" in out.lower()
                     or (errs and float(errs[-1]) < 1e-3))
        assert converged, (name, out)
    got = _counts(out)
    if name in ROUNDING_RULED:
        assert want and all(len(w) == len(got) for w in want), (name, want)
        spans = [(min(c), max(c)) for c in zip(*want)]
        assert got and all(lo <= g <= hi for g, (lo, hi) in zip(got, spans)), (
            name, got, spans)
    else:
        assert got == want, (name, got, want, out)


def test_every_sample_is_ported_and_grouped():
    """The port has one sample per JAX sample, same names, and each
    group below runs each of them once."""
    grouped = sorted(s for g in GROUPS.values() for s in g)
    assert _names(PORT) == _names(JAX_SAMPLES) == grouped
    assert len(grouped) == 40
    assert set(ROUNDING_RULED) <= set(grouped)


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_samples_run_and_give_the_jax_counts(group, monkeypatch, capfd,
                                             jax_draw):
    for name in GROUPS[group]:
        want = _jax_counts(name, monkeypatch, capfd)
        _check(name, _run(PORT, name, monkeypatch, capfd), want)
