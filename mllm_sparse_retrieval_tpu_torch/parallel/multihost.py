"""Several processes (the JAX package's ``parallel/multihost.py``, on
``torch.distributed``).

The JAX package calls ``jax.distributed.initialize`` once per host process,
after which one global mesh spans every host. Here the call is
``torch.distributed.init_process_group``: the arguments default to the
launcher's environment (``MASTER_ADDR`` / ``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``, as ``torchrun`` sets them), the backend is ``nccl`` for CUDA and
``gloo`` for the CPU. With one process, or without an address and a world
size, nothing is initialised. The port's ``parallel.mesh.Mesh`` lives in
one process: a trainer whose data axis spans processes is ROADMAP Queue 1
#9c.
"""

from __future__ import annotations

import os
from typing import Optional

import torch


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device="cuda") -> bool:
    """Join the process group of ``num_processes`` processes at
    ``coordinator_address`` (``host:port`` or ``tcp://host:port``) as
    ``process_id``; returns True when it initialised one. False, with
    nothing changed, for one process, a missing address or world size, or
    a group that already exists."""
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
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=num_processes, rank=process_id)
    return True


def is_primary_host() -> bool:
    """Rank 0 of the process group, or the only process."""
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized():
        return True
    return dist.get_rank() == 0
