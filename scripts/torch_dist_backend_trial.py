"""Which torch.distributed backend serves the port's one-part-per-process
communicator on one NVIDIA GPU: a trial, run on the card.

    python scripts/torch_dist_backend_trial.py [OUT.json]

Starts 2 processes on cuda:0 for each case and runs one all_reduce, one
all_gather and one isend/irecv pair: NCCL on CUDA tensors; gloo on CUDA
tensors as they are; gloo on host tensors (what
rocalution_tpu_torch/parallel/comm.py:ProcessComm does). Each process is
killed after 60 s. Prints one JSON object (and writes it to OUT.json):
per case, each process's exit code, the last line of its output and the
first line that names an error.
"""

import json
import os
import socket
import subprocess
import sys

CASES = {"nccl_cuda": ("nccl", "cuda"), "gloo_cuda": ("gloo", "cuda"),
         "gloo_host": ("gloo", "cpu")}


def worker(address, rank, backend, where):
    import datetime

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=address, world_size=2,
                            rank=rank,
                            timeout=datetime.timedelta(seconds=30))
    dev = torch.device("cuda", 0) if where == "cuda" else torch.device("cpu")
    done = []
    t = torch.full((4,), float(rank + 1), device=dev)
    dist.all_reduce(t)
    done.append(f"all_reduce {t.tolist()}")
    out = [torch.empty_like(t) for _ in range(2)]
    dist.all_gather(out, t)
    done.append("all_gather")
    buf = torch.full((8,), float(rank), device=dev)
    rec = torch.zeros_like(buf)
    work = [dist.isend(buf, 1 - rank), dist.irecv(rec, 1 - rank)]
    for w in work:
        w.wait()
    done.append(f"isend/irecv got {rec[0].item()}")
    if where == "cuda":
        torch.cuda.synchronize()
    print("OK " + "; ".join(done), flush=True)
    dist.destroy_process_group()


def main():
    result = {}
    for case, (backend, where) in CASES.items():
        s = socket.socket()
        s.bind(("localhost", 0))
        address = f"tcp://localhost:{s.getsockname()[1]}"
        s.close()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", address,
             str(rank), backend, where],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for rank in (0, 1)]
        rows = []
        for p in procs:
            try:
                out, _ = p.communicate(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
                out += "\nkilled after 60 s"
            lines = [l for l in out.strip().splitlines() if l.strip()]
            errors = [l for l in lines if "Error" in l or "error" in l]
            rows.append({"rc": p.returncode,
                         "last": lines[-1][-300:] if lines else "",
                         "first_error": errors[0][-300:] if errors else ""})
        result[case] = rows
    text = json.dumps(result)
    print(text)
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        worker(sys.argv[2], int(sys.argv[3]), sys.argv[4], sys.argv[5])
    else:
        main()
