"""Communicators: what a mesh axis is in the port.

The JAX package runs every part of a distributed operator in ONE program
over a device mesh: the parts are stacked (P, ...) arrays, `shard_map`
hands each device its (1, ...) block, and the collectives are
`ppermute`, `all_gather` and `psum` over the axis name
(rocalution_tpu/parallel/partition.py). torch has neither virtual devices
nor `shard_map`, so a communicator takes the axis name's place. The
per-part functions (parallel/ops.py, precond.py, amg_setup.py, the
reductions of solvers/krylov/_common.py) take tensors whose leading axis
holds this process's parts, of length `local`, plus a communicator:

* `StackedComm`: all P parts in this process, on one device (the
  counterpart of `make_mesh(P)`). `ppermute` by a shift is an index shift
  on the part axis, `all_gather` is the stacked buffer itself, and `psum`
  sums the per-part partials over the part axis.
* `ProcessComm`: one part per process over `torch.distributed` (the
  counterpart of parallel/multiproc.py on `jax.distributed`), backend
  gloo, every collective moving its (boundary-sized or scalar) buffer
  through host memory. The choice is fixed, from a trial on one H100
  (scripts/torch_dist_backend_trial.py): NCCL refuses two ranks on one
  GPU, gloo's TCP transport fails on CUDA tensors, and gloo on host
  tensors works.

A `psum` input is a tensor of per-part partials, shape (local, ...): a
reduction first reduces each part on its own (a local dot per shard, as
under `shard_map`), then sums the parts.
"""

from __future__ import annotations

import torch

BACKEND = "gloo"


class StackedComm:
    """All `nparts` parts in this process: the leading axis is the mesh."""

    def __init__(self, nparts: int):
        if nparts < 1:
            raise ValueError(f"need at least one part, got {nparts}")
        self.nparts = self.local = int(nparts)

    def psum(self, v: torch.Tensor) -> torch.Tensor:
        return v.sum(0)

    def pmax(self, v: torch.Tensor) -> torch.Tensor:
        return v.amax(0)

    def ppermute(self, buf: torch.Tensor, shift: int) -> torch.Tensor:
        """Part p + shift receives part p's row of `buf`; a part with no
        sender receives zeros (jax.lax.ppermute's rule)."""
        out = torch.zeros_like(buf)
        P, s = self.nparts, int(shift)
        if abs(s) >= P:
            return out
        if s >= 0:
            out[s:] = buf[:P - s]
        else:
            out[:P + s] = buf[-s:]
        return out

    def all_gather(self, buf: torch.Tensor) -> torch.Tensor:
        """(P, W) rows of every part: the stacked buffer itself."""
        return buf


class ProcessComm:
    """One part per process of an initialized `torch.distributed` group."""

    def __init__(self, group=None):
        import torch.distributed as dist

        self.dist, self.group = dist, group
        self.nparts = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.local = 1

    def _reduce(self, v: torch.Tensor, op) -> torch.Tensor:
        t = v[0].detach().to("cpu", copy=True).contiguous()
        self.dist.all_reduce(t, op=op, group=self.group)
        return t.to(v.device)

    def psum(self, v: torch.Tensor) -> torch.Tensor:
        return self._reduce(v, self.dist.ReduceOp.SUM)

    def pmax(self, v: torch.Tensor) -> torch.Tensor:
        return self._reduce(v, self.dist.ReduceOp.MAX)

    def ppermute(self, buf: torch.Tensor, shift: int) -> torch.Tensor:
        """This process sends its row to rank + shift and receives rank -
        shift's (zeros where that rank does not exist)."""
        dist = self.dist
        send = buf.detach().to("cpu", copy=True).contiguous()
        recv = torch.zeros_like(send)
        dst, src = self.rank + int(shift), self.rank - int(shift)
        work = []
        if 0 <= dst < self.nparts:
            work.append(dist.isend(send, dst, group=self.group))
        if 0 <= src < self.nparts:
            work.append(dist.irecv(recv, src, group=self.group))
        for w in work:
            w.wait()
        return recv.to(buf.device)

    def all_gather(self, buf: torch.Tensor) -> torch.Tensor:
        """(P, W): every process's row of `buf`, in rank order."""
        t = buf.detach().to("cpu", copy=True).contiguous()
        out = [torch.empty_like(t) for _ in range(self.nparts)]
        self.dist.all_gather(out, t, group=self.group)
        return torch.cat(out).to(buf.device)


def process_comm(address: str, world_size: int, rank: int,
                 timeout_s: float = 300.0) -> ProcessComm:
    """Join the process group at ``address`` (``tcp://host:port``) as
    ``rank`` of ``world_size`` over gloo, and return its communicator (the
    counterpart of `rocalution_tpu.backend.init` + `process_mesh`)."""
    import datetime

    import torch.distributed as dist

    if not dist.is_initialized():
        dist.init_process_group(
            BACKEND, init_method=address, world_size=int(world_size),
            rank=int(rank), timeout=datetime.timedelta(seconds=timeout_s))
    return ProcessComm()
