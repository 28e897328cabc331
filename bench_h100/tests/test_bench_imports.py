"""What the harness and the reference load, and the command's refusals:
no module of top-level name jax, jaxlib, flax or rocalution_tpu in a run,
nothing of the port in the reference, and no result without a card or
without the port."""

import json
import os
import shutil
import subprocess
import sys

from bench_h100.tests.conftest import REPO

RUN_TINY = """
import json, sys, time
sys.path.insert(0, {repo!r})
import rocalution_tpu_torch as rt
rt.set_default_device("cpu")
from bench_h100 import harness
for cell in ("heat3d.cg_jacobi", "fem2d.spmm32"):
    harness.run_cell(harness.load_cell(harness.Path({root!r}), cell), 3,
                     0.01, True, "cpu", time.perf_counter(), rt=rt)
tops = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps(tops))
"""

REFERENCE_ONLY = """
import json, sys
sys.path.insert(0, {repo!r})
import bench_h100.reference.cg, bench_h100.reference.checks
import bench_h100.reference.csr
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _python(code, cwd, env=None):
    out = subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _env():
    env = dict(os.environ, ROCALUTION_TPU_TORCH_PLAN_CACHE="0",
               OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    return env


def test_a_run_loads_no_jax_and_no_jax_package(tiny_root):
    tops = _python(RUN_TINY.format(repo=str(REPO), root=str(tiny_root)),
                   tiny_root, _env())
    assert "rocalution_tpu_torch" in tops
    assert not set(tops) & {"jax", "jaxlib", "flax", "rocalution_tpu"}


def test_the_reference_loads_nothing_of_the_port(tmp_path):
    tops = _python(REFERENCE_ONLY.format(repo=str(REPO)), tmp_path, _env())
    assert "torch" in tops
    assert not set(tops) & {"jax", "jaxlib", "flax", "rocalution_tpu",
                            "rocalution_tpu_torch"}


def test_loaded_forbidden_compares_whole_top_level_names(monkeypatch):
    from bench_h100 import harness

    monkeypatch.setitem(sys.modules, "rocalution_tpu_torch_x", sys)
    assert "rocalution_tpu_torch_x" not in harness.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib" in harness.loaded_forbidden()


def _command(cwd, env):
    return subprocess.run(
        [sys.executable, "bench_h100/run.py", "--workload",
         "heat3d.cg_jacobi", "--seed", "2200000000", "--seconds", "1",
         "--trace", "0"], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300)


def test_no_result_without_a_card(tiny_root):
    env = dict(_env(), CUDA_VISIBLE_DEVICES="")
    shutil.copytree(REPO / "rocalution_tpu_torch",
                    tiny_root / "rocalution_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    out = _command(tiny_root, env)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_no_result_with_the_benchmark_alone(tiny_root):
    out = _command(tiny_root, _env())
    assert out.returncode != 0 and out.stdout.strip() == ""
