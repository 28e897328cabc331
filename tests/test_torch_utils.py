"""Port parity: the runtime switches and utils (rocalution_tpu_torch/
config.py, utils/key.py, log.py, profile.py, validate.py).

`matrix_key` gives the JAX package's tuples on the same matrix in CSR and
converted to ELL and DIA, and after a value-only change only its third
part moves, in both packages; the validators raise on tests/test_misc.py's
bad inputs, as the JAX package's do; `profile` writes a trace that
`latest_trace_file` finds; `log_debug` appends one line a solve to the
log file and nothing without one; `set_verbose(0)` silences `log_info` and
`info()`; `set_debug(True)` makes a solver check its operands; the config
reads the port's own environment variables, not the JAX package's.
"""

import os

import numpy as np
import pytest
import torch

import rocalution_tpu as jrt
import rocalution_tpu_torch as rt
from rocalution_tpu.utils import key as jax_key
from rocalution_tpu.utils import validate as jax_validate
from rocalution_tpu_torch.utils import key, log, profile, validate
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ENV = ("ROCALUTION_TPU_TORCH_VERBOSE", "ROCALUTION_TPU_TORCH_DEBUG",
       "ROCALUTION_TPU_TORCH_LOG")


@pytest.fixture(autouse=True)
def on_the_cpu():
    before = rt.config.default_device()
    rt.set_default_device("cpu")
    yield
    rt.set_default_device(before)


@pytest.fixture
def config(monkeypatch):
    """The config object, its switches restored after the test."""
    cfg = rt.get_config()
    for name in ("verbose", "debug", "log_file"):
        monkeypatch.setattr(cfg, name, getattr(cfg, name))
    return cfg


def _port(Aj):
    return rt.CSR.from_arrays(*Aj.numpy_triplet(), Aj.shape)


@pytest.mark.parametrize("fmt", ["CSR", "ELL", "DIA"])
def test_matrix_key_equals_jax(fmt):
    Aj = jrt.laplacian_2d(12)
    At = _port(Aj)
    if fmt != "CSR":
        Aj, At = jrt.convert(Aj, fmt), rt.convert(At, fmt)
    assert key.matrix_key(At) == jax_key.matrix_key(Aj)
    assert key.matrix_key(At) == key.matrix_key(rt.laplacian_2d(12))
    assert key.matrix_key(At) != key.matrix_key(rt.laplacian_2d(13))


def test_matrix_key_value_change_moves_the_third_part():
    Aj = jrt.laplacian_2d(12)
    d, i, p = Aj.numpy_triplet()
    Dj = jrt.CSR.from_arrays(d * 2.0, i, p, Aj.shape)
    kt = key.matrix_key(_port(Aj))
    kd = key.matrix_key(rt.CSR.from_arrays(d * 2.0, i, p, Aj.shape))
    assert kt[:2] == kd[:2] and kt[2] != kd[2]
    assert kd == jax_key.matrix_key(Dj)


def test_validators_raise_as_jax():
    """tests/test_misc.py:test_validators' inputs, through both packages,
    and the SPD probe on an SPD and a negated operator."""
    bad = (np.array([np.inf]), np.array([0]), np.array([0, 1]), (1, 1))
    for mod, pkg in ((validate, rt), (jax_validate, jrt)):
        mod.check_matrix(pkg.laplacian_2d(6))
        mod.check_vector(np.ones(5))
        with pytest.raises(mod.ValidationError):
            mod.check_vector(np.array([1.0, np.nan]))
        with pytest.raises(mod.ValidationError):
            mod.check_matrix(pkg.CSR.from_arrays(*bad))
        A = pkg.laplacian_2d(6)
        mod.assert_spd_sample(A)
        d, i, p = A.numpy_triplet()
        with pytest.raises(mod.ValidationError, match="not SPD"):
            mod.assert_spd_sample(pkg.CSR.from_arrays(-d, i, p, A.shape))
    validate.check_vector(torch.ones(3))
    with pytest.raises(validate.ValidationError):
        validate.check_vector(torch.tensor([0.0, float("inf")]))


def test_profile_writes_a_trace(tmp_path):
    A = rt.laplacian_2d(8)
    b = rt.spmv(A, torch.ones(A.shape[0], dtype=A.dtype))
    logdir = str(tmp_path / "trace")
    with profile.profile(logdir) as d:
        assert d == logdir
        with profile.annotate("cg-smoke"):
            x, info = rt.cg(A, b, rel_tol=1e-8, max_iter=100)
    path = profile.latest_trace_file(logdir)
    assert path is not None and path.startswith(logdir)
    with open(path) as f:
        assert "cg-smoke" in f.read()
    with profile.profile(str(tmp_path / "unused"), enabled=False) as d:
        assert d is None
    assert not os.path.exists(tmp_path / "unused")
    assert profile.latest_trace_file(str(tmp_path / "unused")) is None


def test_log_debug_writes_one_line_a_solve(tmp_path, config):
    A = rt.laplacian_2d(8)
    b = rt.spmv(A, torch.ones(A.shape[0], dtype=A.dtype))
    path = tmp_path / "calls.log"
    config.log_file = None
    rt.cg(A, b, rel_tol=1e-8)
    assert not path.exists()
    config.log_file = str(path)
    rt.cg(A, b, rel_tol=1e-8)
    rt.gmres(A, b, rel_tol=1e-8)
    lines = path.read_text().splitlines()
    assert len(lines) == 2
    assert all("CSR::solve(torch.Size([64])" in s for s in lines)
    assert f"[pid {os.getpid()}]" in lines[0]
    config.log_file = None
    rt.cg(A, b, rel_tol=1e-8)
    assert len(path.read_text().splitlines()) == 2


def test_set_verbose_silences_info(config, capsys):
    rt.set_verbose(0)
    log.log_info("hidden")
    text = rt.info()
    assert "rocalution_tpu_torch platform info" in text
    assert capsys.readouterr().out == ""
    rt.set_verbose(1)
    log.log_info("shown")
    log.log_verbose(2, "not at 1")
    rt.info()
    out = capsys.readouterr().out
    assert out.startswith("shown\n") and "platform info" in out
    assert "not at 1" not in out
    rt.set_verbose(2)
    log.log_verbose(2, "at 2")
    assert capsys.readouterr().out == "at 2\n"


def test_set_debug_checks_solver_operands(config):
    d, i, p = rt.laplacian_2d(6).numpy_triplet()
    bad = rt.CSR.from_arrays(np.where(np.arange(len(d)) == 3, np.inf, d), i,
                             p, (36, 36))
    b = torch.ones(36, dtype=torch.float64)
    rt.set_debug(False)
    rt.cg(bad, b, max_iter=5)                     # no check without debug
    rt.set_debug(True)
    assert rt.get_config().debug
    with pytest.raises(validate.ValidationError, match="non-finite"):
        rt.cg(bad, b, max_iter=5)
    good = rt.CSR.from_arrays(d, i, p, (36, 36))
    with pytest.raises(validate.ValidationError, match="rhs"):
        rt.cg(good, torch.full((36,), float("nan"), dtype=torch.float64))
    _, info = rt.cg(good, b, rel_tol=1e-8)
    assert int(info.status) in (1, 2)


def test_config_fields_and_environment(monkeypatch):
    """Defaults, the port's variables, and none of the JAX package's."""
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("ROCALUTION_TPU_VERBOSE", "3")
    monkeypatch.setenv("ROCALUTION_TPU_DEBUG", "1")
    monkeypatch.setenv("ROCALUTION_TPU_LOG", "jax.log")
    cfg = rt.config.Config()
    assert (cfg.verbose, cfg.debug, cfg.log_file) == (1, False, None)
    assert cfg.default_dtype == torch.float64
    assert cfg.index_dtype == torch.int32 == rt.config.index_dtype()
    assert cfg.default_device == torch.device("cuda")
    assert cfg.auto_wjd is None
    monkeypatch.setenv("ROCALUTION_TPU_TORCH_VERBOSE", "2")
    monkeypatch.setenv("ROCALUTION_TPU_TORCH_DEBUG", "1")
    monkeypatch.setenv("ROCALUTION_TPU_TORCH_LOG", "port.log")
    cfg = rt.config.Config()
    assert (cfg.verbose, cfg.debug, cfg.log_file) == (2, True, "port.log")
    assert rt.get_config() is rt.config.get_config()
    assert rt.utils.generators.default_dtype() == torch.float64
