"""The port's one-part-per-process path (parallel/multiproc.py): two real
processes join a gloo group on a free localhost port, each builds only
its own row block of laplacian_2d(24) (`laplacian_2d_block`) and its part
of the operator (`global_csr_multiproc`: only ghost-column metadata
crosses the processes), and both run one CG + Jacobi
(`dist_solve_spmd`). Each process's arrays must equal its row of the
single-process operator (`distribute_csr` over 2 parts), and the count and
x must equal the single-process communicator's solve, in both halo modes.
The processes are killed if they outlive their timeout.

Run as a script, this file is one of the two processes:
``python tests/test_torch_multiproc.py ADDRESS RANK WORLD SHIFTS``.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 24
WORLD = 2
KW = dict(rel_tol=1e-10, max_iter=500)
TIMEOUT_S = 120


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _worker(address, rank, world, shifts):
    import torch

    import rocalution_tpu_torch as rt
    from rocalution_tpu_torch import parallel as tpar
    from rocalution_tpu_torch.parallel.multiproc import (
        dist_solve_spmd, global_csr_multiproc, process_comm)
    from rocalution_tpu_torch.parallel.partition import ARRAY_FIELDS

    rt.set_default_device("cpu")
    torch.set_num_threads(1)     # processes sharing the host's cores
    comm = process_comm(address, world, rank)
    NN = N * N
    nl = -(-NN // world)
    lo, hi = rank * nl, min(NN, (rank + 1) * nl)
    block = rt.utils.generators.laplacian_2d_block(N, lo, hi)
    Ag = global_csr_multiproc(block, (NN, NN), comm,
                              max_neighbor_shifts=shifts)
    # this part's arrays are its row of the single-process operator
    ref = tpar.distribute_csr(rt.laplacian_2d(N), world,
                              max_neighbor_shifts=shifts)
    same = all(torch.equal(getattr(Ag, k)[0], getattr(ref, k)[rank])
               for k in ARRAY_FIELDS)
    r, c, d = block
    b = np.zeros(Ag.n_local)
    np.add.at(b, r, d)
    diag = np.ones(Ag.n_local)
    own = c - lo == r
    np.add.at(diag, r[own], d[own] - 1.0)
    x_true = np.zeros(Ag.n_local)
    x_true[: hi - lo] = 1.0
    x, info, err = dist_solve_spmd(rt.cg, Ag, b, comm,
                                   inv_diag_local=1.0 / diag,
                                   x_true_local=x_true, **KW)
    print(json.dumps({
        "rank": rank, "mode": Ag.mode, "same_arrays": same,
        "status": int(info.status), "iterations": int(info.iterations),
        "err": err, "x": x.tolist()}), flush=True)
    torch.distributed.destroy_process_group()


@pytest.mark.parametrize("shifts", [6, 0], ids=["ppermute", "allgather"])
def test_two_gloo_processes_match_one(shifts):
    import rocalution_tpu_torch as rt
    from rocalution_tpu_torch import parallel as tpar

    address = f"tcp://localhost:{_free_port()}"
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), address, str(rank),
         str(WORLD), str(shifts)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
        for rank in range(WORLD)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT_S)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(outs)
    got = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    assert [g["mode"] for g in got] == [
        "ppermute" if shifts else "allgather"] * WORLD
    assert all(g["same_arrays"] for g in got)

    before = rt.config.default_device()
    rt.set_default_device("cpu")
    try:
        A = rt.laplacian_2d(N)
        Ag = tpar.distribute_csr(A, WORLD, max_neighbor_shifts=shifts)
        b = rt.spmv(A, A.data.new_ones(A.shape[0]))
        x, info = tpar.dist_solve(rt.cg, Ag, b, M=tpar.block_jacobi_diag(Ag),
                                  **KW)
    finally:
        rt.set_default_device(before)
    for g in got:
        assert (g["status"], g["iterations"]) == (int(info.status),
                                                  int(info.iterations))
        assert g["err"] < 1e-8
    x_mp = np.concatenate([g["x"] for g in got])[: A.shape[0]]
    np.testing.assert_array_equal(x_mp, x.numpy())


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
            int(sys.argv[4]))
