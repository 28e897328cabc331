"""The port's benchmark CLI (rocalution_tpu_torch/bench_cli.py) on the CPU:
tests/test_clients.py's three CLI tests run through `main(argv)` in this
process, the plot and compare tools and the port's twin of
scripts/bench_execute.py (scripts/bench_execute_torch.py) on its output;
two cases held to the JAX CLI's `run_case` (same keys, `iter` and
`convergence`); and every solver and preconditioner name of the CLI
mapped to a counterpart that builds and solves.
"""

import argparse
import json
import os
import subprocess
import sys

import jax
import pytest
import torch

import rocalution_tpu.bench_cli as jax_cli
import rocalution_tpu_torch as rt
from rocalution_tpu_torch import bench_cli
from test_torch_native import natives_loaded  # noqa: F401  (autouse)
from test_torch_native import plan_cache_off  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HELD = {
    # the two cases of tests/test_clients.py:16 and :34
    "cg_jacobi_dia_16": ["--solver", "cg", "--precond", "jacobi",
                         "--format", "DIA", "--size", "16", "--tol", "1e-8"],
    "saamg_24": ["--solver", "saamg", "--size", "24"],
}
# the port's rows carry exactly the JAX CLI's keys (bench_cli.py:183-199)
KEYS = {"solver", "precond", "format", "engine", "matrix", "n", "nnz",
        "convergence", "iter", "norm_residual", "time_import_s",
        "time_analyze_s", "time_solve_s", "time_global_s", "nrmmax_err"}


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The CPU and one torch thread (the small solves' ops slow down when
    each test worker's threads contend for the cores)."""
    before = rt.config.default_device(), torch.get_num_threads()
    rt.set_default_device("cpu")
    torch.set_num_threads(1)
    yield
    rt.set_default_device(before[0])
    torch.set_num_threads(before[1])


def _main(argv, capsys):
    """The port's CLI in this process: its exit code and JSON lines."""
    rc = bench_cli.main(argv)
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    return rc, lines


def _jax_args(argv):
    """The JAX CLI's namespace for one case of `argv`."""
    a = dict(solver="cg", precond="none", fmt="CSR", matrix="laplacian2d",
             file=None, size=64, dtype="float64", tol=1e-8, abs_tol=1e-15,
             max_iter=10000, out=None, verbose=False)
    it = iter(argv)
    for flag in it:
        key = {"--format": "fmt"}.get(flag, flag[2:].replace("-", "_"))
        a[key] = type(a[key])(next(it)) if a[key] is not None else next(it)
    return argparse.Namespace(**a)


@pytest.fixture(scope="module")
def jax_rows():
    """The JAX CLI's row of each held case, once per module. Its
    `run_case` points JAX's compilation cache at a fixed directory; here
    that setting is skipped, so the test writes nothing outside pytest's
    own directories."""
    update = jax.config.update

    def no_cache_dir(name, value):
        if name != "jax_compilation_cache_dir":
            update(name, value)

    mp = pytest.MonkeyPatch()
    mp.setattr(jax.config, "update", no_cache_dir)
    try:
        return {case: jax_cli.run_case(_jax_args(argv))
                for case, argv in HELD.items()}
    finally:
        mp.undo()


def test_bench_cli_json(capsys):
    rc, lines = _main(HELD["cg_jacobi_dia_16"], capsys)
    assert rc == 0
    res = lines[-1]
    assert res["convergence"] is True
    assert res["iter"] > 0
    assert res["nrmmax_err"] < 1e-5
    for k in ("time_import_s", "time_analyze_s", "time_solve_s"):
        assert k in res
    assert res["engine"] == "plain"       # no kernel launches on the CPU


def test_bench_cli_amg(capsys):
    rc, lines = _main(HELD["saamg_24"], capsys)
    assert rc == 0
    assert lines[-1]["convergence"] is True


@pytest.mark.parametrize("case", sorted(HELD))
def test_rows_match_the_jax_cli(case, capsys, jax_rows):
    _, lines = _main(HELD[case], capsys)
    got, want = lines[-1], jax_rows[case]
    assert set(got) == set(want) == KEYS
    for key in ("iter", "convergence", "solver", "precond", "format",
                "matrix", "n", "nnz"):
        assert got[key] == want[key], key


def test_bench_cli_sweep_and_tools(tmp_path, capsys):
    """Sweep expander: comma lists expand to the cartesian product, one
    JSON line per case plus a summary; bench_plot renders the JSONL and
    compares it with itself; the port's bench_execute twin runs a cases
    file through `python -m rocalution_tpu_torch.bench_cli`."""
    out_file = str(tmp_path / "sweep.jsonl")
    rc, lines = _main(["--solver", "cg,bicgstab", "--precond",
                       "none,jacobi", "--size", "12,16", "--out", out_file],
                      capsys)
    assert rc == 0
    summary = lines[-1]["sweep_summary"]
    assert summary["cases"] == 8 and summary["converged"] == 8
    assert sum(1 for r in lines[:-1] if r.get("convergence")) == 8
    env = {"PATH": os.environ["PATH"], "HOME": str(tmp_path),
           "PYTHONPATH": ROOT}
    plot = [sys.executable, "scripts/bench_plot.py", out_file]
    out2 = subprocess.run(plot, capture_output=True, text=True, env=env,
                          timeout=60, cwd=ROOT)
    assert out2.returncode == 0 and out2.stdout.count("\n") >= 9
    out3 = subprocess.run(plot + ["--compare", out_file],
                          capture_output=True, text=True, env=env,
                          timeout=60, cwd=ROOT)
    assert out3.returncode == 0 and "1.00x" in out3.stdout
    # the twin's subprocesses start on the CPU by way of a sitecustomize
    # module (the port's default device is the card)
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(
        "import rocalution_tpu_torch as rt\nrt.set_default_device('cpu')\n")
    cases = tmp_path / "cases.json"
    cases.write_text(json.dumps({"cmdlines": [
        "--solver cg --precond jacobi --size 12",
        "--solver gmres --precond ilu --format ELL --size 12"]}))
    twin_out = str(tmp_path / "twin.jsonl")
    env["PYTHONPATH"] = f"{site}{os.pathsep}{ROOT}"
    out4 = subprocess.run(
        [sys.executable, "scripts/bench_execute_torch.py", str(cases),
         "--out", twin_out], capture_output=True, text=True, env=env,
        timeout=300, cwd=ROOT)
    assert out4.returncode == 0, out4.stderr[-2000:]
    assert json.loads(out4.stdout.splitlines()[-1]) == {"executed": 2,
                                                        "failed": 0}
    with open(twin_out) as f:
        rows = [json.loads(s) for s in f]
    assert [(r["solver"], r["engine"], r["convergence"]) for r in rows] == [
        ("cg", "plain", True), ("gmres", "plain", True)]
    out5 = subprocess.run(plot[:2] + [twin_out, "--compare", twin_out],
                          capture_output=True, text=True, env=env,
                          timeout=60, cwd=ROOT)
    assert out5.returncode == 0 and "1.00x" in out5.stdout


def test_every_name_has_a_counterpart():
    """The CLI's lists are the JAX CLI's, and each name maps to the port's
    counterpart: a solver of the package, a preconditioner builder, an
    AMG kind."""
    for name in ("SOLVERS", "PRECONDS", "FORMATS", "MATRICES"):
        assert getattr(bench_cli, name) == getattr(jax_cli, name), name
    assert set(bench_cli.precond_table()) == set(bench_cli.PRECONDS)
    for name in bench_cli.SOLVERS:
        assert name in bench_cli.AMG_KINDS or callable(getattr(rt, name))


@pytest.mark.parametrize("sweep", [
    ["--solver", ",".join(bench_cli.SOLVERS), "--precond", "jacobi"],
    ["--solver", "fgmres", "--precond", ",".join(bench_cli.PRECONDS)],
], ids=["solvers", "preconds"])
def test_every_name_builds_and_solves(sweep, capsys):
    """No case of a sweep over every name fails to build or run (a name
    without a counterpart would give an error row)."""
    _, lines = _main(sweep + ["--size", "12", "--max-iter", "400"], capsys)
    rows = lines[:-1]
    assert len(rows) == max(len(sweep[1].split(",")),
                            len(sweep[3].split(",")))
    assert not [r for r in rows if "error" in r]
