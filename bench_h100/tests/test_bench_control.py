"""What decides `correct`, at a size a test run holds, on the CPU: the
program passes its limits; the control (the reference in float32 in the
program's place) and each fault planted under the timed path fail."""

import pytest
import torch

from bench_h100 import harness

CELLS = ("heat3d.cg_jacobi", "fem2d.spmm32")


class Broken:
    """The port with one entry point replaced."""

    def __init__(self, rt, **swap):
        self._rt = rt
        self.__dict__.update(swap)

    def __getattr__(self, name):
        return getattr(self._rt, name)


def _solve_fault(rt, fault):
    def cg(A, b, **kw):
        x, info = rt.cg(A, b, **kw)
        if fault == "unchanged":              # the initial guess handed back
            x = kw["x0"]
        elif fault == "half":                 # half of the unknowns left out
            x = x.clone()
            x[x.shape[0] // 2:] = 0
        elif fault == "altered":              # one entry off by 1e-6
            x = x.clone()
            x[x.shape[0] // 3] *= 1 + 1e-6
        return x, info
    return Broken(rt, cg=cg)


def _apply_fault(rt, fault):
    last = {}

    def spmv(A, X):
        Y = rt.spmv(A, X)
        if fault == "unchanged":              # the last product handed back
            Y, last["Y"] = last.get("Y", Y), Y
        elif fault == "half":                 # one chunk of columns left out
            Y = Y.clone()
            Y[:, Y.shape[1] // 2:] = 0
        elif fault == "altered":
            Y = Y.clone()
            Y[Y.shape[0] // 3, 5] *= 1 + 1e-6
        return Y
    return Broken(rt, spmv=spmv)


def _run(root, cell, rt, seed=11, trace=False):
    c = harness.load_cell(root, cell)
    return harness.run_cell(c, seed, 0.2, trace, "cpu", 0.0, rt=rt)


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_is_correct_and_the_control_is_not(cell, tiny_root,
                                                       port_on_cpu):
    out = _run(tiny_root, cell, port_on_cpu)
    assert out["correct"], out["checks"]
    c = harness.load_cell(tiny_root, cell)
    run, stream = harness.new_run(c, 12, "cpu", port_on_cpu)
    run.counters = {}
    stream.make_inputs(run)
    stream.control(run, c.spec["sample"] + 1, torch.float32)
    checks, bad = harness.judge(stream.check(run), c)
    assert bad > 0
    assert any(v["value"] > v["limit"] for v in checks.values()), checks


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_under_the_timed_path_is_not_correct(cell, fault, tiny_root,
                                                     port_on_cpu):
    broken = (_solve_fault if cell.startswith("heat3d") else _apply_fault)(
        port_on_cpu, fault)
    for trace in (False, True):
        out = _run(tiny_root, cell, broken, trace=trace)
        assert not out["correct"], (fault, trace, out["checks"])
        assert out["failed"] > 0
