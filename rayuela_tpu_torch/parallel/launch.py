"""Multi-process bootstrap (counterpart of `rayuela_tpu/parallel/launch.py`).

PyTorch runs one process a GPU. Launch them with ``torchrun``, which
sets ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``::

    torchrun --nproc-per-node=4 my_script.py

    from rayuela_tpu_torch.parallel import (global_mesh,
                                            host_local_to_global,
                                            initialize)
    initialize()                      # env-driven; no-op alone
    mesh = global_mesh(n_model=1)     # (data, model) over ALL ranks
    Bg = host_local_to_global(mesh, B_local)   # this rank's rows only

A plain single-process run is untouched: `initialize()` returns False and
does nothing when no launcher configured it, and `global_mesh()` is then
the one-rank mesh, so one script runs from one card to many.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from rayuela_tpu_torch.parallel.mesh import (Mesh, RowShard, _all_gather,
                                             make_mesh)


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *,
               backend: str | None = None,
               timeout: float | None = None) -> bool:
    """Initialize `torch.distributed` when a multi-process launch is
    configured; returns True if distributed mode is active.

    Configuration, in order: the arguments (``coordinator_address`` as
    ``host:port`` or an init URL such as ``tcp://host:port`` or
    ``file:///path``), then the variables ``torchrun`` sets
    (``MASTER_ADDR`` / ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``). With
    none of them it does nothing and returns False. ``backend`` is
    ``nccl`` for the card (the rank then takes card ``LOCAL_RANK``, or
    its rank modulo the cards) and ``gloo`` for CPU tensors; by default
    ``nccl`` where a card exists. ``timeout`` (seconds) bounds every
    collective."""
    if dist.is_initialized():
        return True
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None and num_processes is None:
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    url = coordinator_address
    if url is not None and "://" not in url:
        url = f"tcp://{url}"
    kw = {}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout)
    if backend == "nccl":
        local = int(env.get("LOCAL_RANK", process_id or 0))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes if num_processes
                            is not None else -1,
                            rank=process_id if process_id is not None
                            else -1, **kw)
    return True


def global_mesh(n_data: int | None = None, n_model: int = 1,
                device=None) -> Mesh:
    """A ``(data, model)`` mesh over all ranks (the one-rank mesh without
    a process group): `mesh.make_mesh`, under the JAX package's name for
    multi-host runs."""
    return make_mesh(n_data, n_model, device)


def host_local_to_global(mesh: Mesh, x_local, axis: int = 0) -> RowShard:
    """This rank's own rows ``x_local`` as a row-sharded array over the
    ``data`` axis: the global row count and the rank's first row come
    from an all-gather of the ranks' sizes, so the ranks may hold uneven
    shares and no rank ever holds the whole array (ranks that share a
    ``data`` coordinate pass the same rows)."""
    x = torch.as_tensor(x_local).to(mesh.device)
    sizes = _all_gather(mesh, torch.tensor([x.shape[axis]],
                                           device=mesh.device))
    sizes = [int(s) for s in sizes]
    r = mesh.coords["data"]
    return RowShard(x, sum(sizes[:r]), sum(sizes), axis)
