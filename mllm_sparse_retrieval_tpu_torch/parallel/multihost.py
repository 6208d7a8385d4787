"""Several processes (the JAX package's ``parallel/multihost.py``, on
``torch.distributed``).

The JAX package calls ``jax.distributed.initialize`` once per host process,
after which one global mesh spans every host and XLA places the collectives
of the jitted step. Here the call is ``torch.distributed.init_process_group``:
the arguments default to the launcher's environment (``MASTER_ADDR`` /
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, as ``torchrun`` sets them), the
backend is ``nccl`` for CUDA and ``gloo`` for the CPU unless the caller
names one (``gloo`` on CUDA tensors runs several processes on one card,
which ``nccl`` refuses). After it, ``parallel.mesh.make_mesh`` builds a mesh
whose data axis spans the processes, and the trainer calls the collectives
below by name:

- ``all_gather_rows``: every process's tensor, concatenated along a dim,
  differentiable (``torch.distributed.nn.functional.all_gather``): the
  backward sums each piece's gradient over the processes and hands every
  process its own piece (a reduce-scatter on ``nccl``; an all-to-all made of
  scatters on ``gloo``). The sharded loss gathers its rows with it, and a
  weight split over the processes (FSDP) is gathered per use with it, so its
  gradient arrives reduce-scattered on the pieces.
- ``all_reduce_``: a sum in place, for the gradients of the leaves every
  process holds whole.
- ``all_gather_each``: for each of several tensors, every process's piece
  concatenated along dim 0, without a gradient (the rows each process
  updated under ZeRO-1), in one collective per device and dtype.
- ``global_sum``: a scalar whose value is the sum over the processes and
  whose gradient is the local one (the loss a process reports, while its
  gradient stays its own share of the global loss).

``gloo`` takes CUDA tensors in each of these (all-reduce, all-gather,
reduce-scatter, scatter and broadcast, and the gathered rows' backward,
probed with torch 2.11 on the H100 machine), so no tensor is copied through
the host. The collectives run where autograd runs the node that calls them:
on a card's autograd thread for CUDA tensors, so every process issues them
in the same order.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch


@dataclass(frozen=True)
class ProcessView:
    """This process in its group: its rank, the group's size and backend
    (``0, 1, None`` without a group)."""
    rank: int
    world_size: int
    backend: Optional[str]


def process_view() -> ProcessView:
    """The default process group as this process sees it."""
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized():
        return ProcessView(0, 1, None)
    return ProcessView(dist.get_rank(), dist.get_world_size(),
                       str(dist.get_backend()))


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device="cuda", backend: Optional[str] = None
                         ) -> bool:
    """Join the process group of ``num_processes`` processes at
    ``coordinator_address`` (``host:port`` or ``tcp://host:port``) as
    ``process_id``; returns True when it initialised one. False, with
    nothing changed, for one process, a missing address or world size, or
    a group that already exists. ``backend`` defaults to ``nccl`` for a
    CUDA ``device`` and ``gloo`` otherwise; it is never changed behind the
    caller's back. For CUDA, this process's first card (``local_devices``)
    becomes the current device."""
    import torch.distributed as dist

    if num_processes is None:
        env = os.environ.get("WORLD_SIZE")
        num_processes = int(env) if env else None
    if num_processes is None or num_processes <= 1:
        return False
    if coordinator_address is None:
        addr, port = os.environ.get("MASTER_ADDR"), os.environ.get(
            "MASTER_PORT")
        if not addr or not port:
            return False
        coordinator_address = f"{addr}:{port}"
    if process_id is None:
        env = os.environ.get("RANK")
        if env is None:
            return False
        process_id = int(env)
    if not dist.is_available() or dist.is_initialized():
        return False
    if "://" not in coordinator_address:
        coordinator_address = "tcp://" + coordinator_address
    cuda = torch.device(device).type == "cuda"
    if backend is None:
        backend = "nccl" if cuda else "gloo"
    if cuda:
        torch.cuda.set_device(local_devices(process_id)[0])
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=num_processes, rank=process_id)
    return True


def local_devices(rank: Optional[int] = None) -> List[torch.device]:
    """The cards of process ``rank`` (default: this one's), at its
    ``LOCAL_RANK`` (default: its rank). Where the launcher sets
    ``LOCAL_WORLD_SIZE`` (``torchrun`` does) and the host has at least that
    many cards, they are split evenly over its processes (one process per
    host takes them all); otherwise a process takes one card, round-robin
    (two processes on one card share it)."""
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("local_devices: no CUDA device")
    if rank is None:
        rank = process_view().rank
    local = int(os.environ.get("LOCAL_RANK", rank))
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", "0"))
    if per_host <= 0 or per_host > n:
        return [torch.device("cuda", local % n)]
    k = n // per_host
    return [torch.device("cuda", i) for i in range(local * k, (local + 1) * k)]


def is_primary_host() -> bool:
    """Rank 0 of the process group, or the only process."""
    return process_view().rank == 0


def all_gather_rows(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every process's ``x`` concatenated along ``dim`` in rank order, on
    ``x``'s device, differentiable: the gradient of each process's piece is
    summed over the processes and lands on that process's ``x``. Every
    process passes the same shape."""
    from torch.distributed.nn.functional import all_gather

    return torch.cat(all_gather(x.contiguous()), dim=dim)


@torch.no_grad()
def all_reduce_(tensors: Sequence[torch.Tensor]) -> None:
    """Sum each tensor over the processes, in place: one all-reduce of a
    flat buffer per device and dtype (hundreds of small adapter gradients
    in one call)."""
    import torch.distributed as dist

    groups = {}
    for t in tensors:
        groups.setdefault((t.device, t.dtype), []).append(t)
    for group in groups.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


@torch.no_grad()
def all_gather_each(pieces: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """For each of ``pieces``, every process's piece concatenated along dim
    0 in rank order (no gradient): one all-gather of a flat buffer per
    device and dtype. Every process passes pieces of the same shapes."""
    import torch.distributed as dist

    n = process_view().world_size
    out: List[Optional[torch.Tensor]] = [None] * len(pieces)
    groups = {}
    for i, x in enumerate(pieces):
        groups.setdefault((x.device, x.dtype), []).append(i)
    for idx in groups.values():
        flat = torch.cat([pieces[i].reshape(-1) for i in idx])
        parts = [torch.empty_like(flat) for _ in range(n)]
        dist.all_gather(parts, flat)
        offset = 0
        for i in idx:
            size = pieces[i].numel()
            out[i] = torch.cat([part[offset:offset + size].view_as(pieces[i])
                                for part in parts])
            offset += size
    return out


def barrier() -> None:
    """Wait for every process of the group."""
    import torch.distributed as dist

    dist.barrier()


def global_sum(share: torch.Tensor) -> torch.Tensor:
    """``share`` (a scalar) with the value of its sum over the processes and
    the gradient of ``share`` alone: summing the processes' gradients then
    gives the gradient of the sum."""
    total = share.detach().clone()
    all_reduce_([total])
    return share + (total - share.detach())
