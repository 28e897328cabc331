"""True multi-process distributed CG, the MPI-sample analog.

Reference parity: clients/samples/cg_mpi.cpp: every rank builds ITS OWN
matrix part + ParallelManager from local data, then all ranks run the
same solver (docs/api-reference/multinode.rst:126-155). Port of
clients/samples/multiprocess_cg.py: each PROCESS builds its row block
with a per-rank generator, exchanges only boundary metadata
(parallel/multiproc.py) and runs the solver over torch.distributed
(gloo; `process_comm` in place of the JAX distributed runtime).

Launch one instance per process, on one device each:

    S=clients/samples_torch/multiprocess_cg.py
    python $S tcp://localhost:9876 0 2 cuda &
    python $S tcp://localhost:9876 1 2 cuda

With no arguments it launches a 2-process run of itself on the default
device (a smoke test).
"""

import sys

import numpy as np

WORKER_TIMEOUT_S = 240


def _orchestrate():
    """No-args mode: launch a 2-process run of this sample (smoke test)."""
    import os
    import socket
    import subprocess

    import rocalution_tpu_torch as rt

    s = socket.socket()
    s.bind(("localhost", 0))
    address = f"tcp://localhost:{s.getsockname()[1]}"
    s.close()
    here = os.path.abspath(__file__)
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.dirname(here)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    device = str(rt.config.default_device())
    procs = [subprocess.Popen([sys.executable, here, address, str(p), "2",
                               device], env=env) for p in (0, 1)]
    try:
        rcs = [p.wait(timeout=WORKER_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert rcs == [0, 0], rcs
    print("status=2 (2-process orchestration OK)")


def main():
    if len(sys.argv) < 5:
        return _orchestrate()
    address, pid, nproc = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    import torch

    import rocalution_tpu_torch as rt
    from rocalution_tpu_torch.parallel.multiproc import (
        dist_solve_spmd, global_csr_multiproc, process_comm)

    rt.set_default_device(sys.argv[4])
    torch.set_num_threads(1)     # processes sharing the host's cores
    comm = process_comm(address, nproc, pid)

    n = 48                       # 48x48 grid = 2304 unknowns
    N = n * n
    nl = -(-N // nproc)
    lo, hi = pid * nl, min(N, (pid + 1) * nl)
    from rocalution_tpu_torch.utils.generators import laplacian_2d_block

    block = laplacian_2d_block(n, lo, hi)

    Ag = global_csr_multiproc(block, (N, N), comm)

    # rhs for x_true = 1 and the Jacobi diagonal, from LOCAL data only
    r, c, d = block
    b_local = np.zeros(Ag.n_local)
    np.add.at(b_local, r, d)
    diag = np.ones(Ag.n_local)
    own = c - lo == r
    np.add.at(diag, r[own], d[own] - 1.0)
    x_true = np.zeros(Ag.n_local)
    x_true[: hi - lo] = 1.0

    x_own, info, err = dist_solve_spmd(
        rt.cg, Ag, b_local, comm, inv_diag_local=1.0 / diag,
        x_true_local=x_true, rel_tol=1e-10, max_iter=500)
    if pid == 0:
        print(f"MPROC_OK procs={nproc} iters={int(info.iterations)} "
              f"status={int(info.status)} err={err:.3e}", flush=True)
    torch.distributed.destroy_process_group()
    assert int(info.status) in (1, 2) and err < 1e-6


if __name__ == "__main__":
    main()
