"""Process-group bring-up and host-side collective helpers over
``torch.distributed`` (the counterpart of
``sdvar_tpu/parallel/distributed.py``).

``initialize`` joins this process to the group: the JAX package's variables
(``SDVAR_NUM_PROCESSES``, ``SDVAR_PROCESS_ID``, ``SDVAR_COORDINATOR``) or
torchrun's (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``, which
win where set). With one process it is a no-op, and every helper below
then acts on this process alone, as in the JAX package.

The backend follows one rule, printed at start: NCCL when each rank of the
host has a card of its own, gloo when ranks share a card or run on the
CPU (NCCL refuses two ranks on one device). Gloo takes CUDA tensors too,
staged through host memory. The group's ``timeout`` is finite, so a rank
that stops answering fails its peers' next collective with an error
instead of a hang.

Device collectives of the model (the all-reduces and all-gathers of
tensor parallelism) go through ``parallel.mesh.Mesh``; the helpers here are
for host values (metrics, barriers, request streams).
"""

from __future__ import annotations

import datetime
import functools
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(minutes=5)

_HOST_GROUP = None  # a gloo group for host tensors when the backend is NCCL


def _env_int(*names, default: int) -> int:
    for n in names:
        if n in os.environ:
            return int(os.environ[n])
    return default


def local_rank() -> int:
    """This process's index among the ranks of its host."""
    return _env_int("LOCAL_RANK", "SDVAR_PROCESS_ID", "RANK", default=0)


def local_world_size() -> int:
    return _env_int("LOCAL_WORLD_SIZE", "SDVAR_NUM_PROCESSES", "WORLD_SIZE",
                    default=1)


def backend_rule() -> tuple:
    """(backend, reason): NCCL when each rank of the host has a card of
    its own, else gloo."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = local_world_size()
    if cards == 0:
        return "gloo", "no card: the ranks run on the CPU"
    if cards < n:
        return "gloo", f"{n} ranks share {cards} card(s)"
    return "nccl", f"{n} ranks, one card each of {cards}"


def rank_device() -> torch.device:
    """The device of this rank: cuda:(local rank mod cards) where there is
    a card (two ranks on one card share cuda:0), else the CPU."""
    if not torch.cuda.is_available():
        return torch.device("cpu")
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Join the process group; a no-op with one process or when joined."""
    global _HOST_GROUP
    if dist.is_initialized():
        return
    if "WORLD_SIZE" in os.environ and num_processes is None:
        num = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ.get("RANK", "0"))
        addr = coordinator_address or (
            f"{os.environ.get('MASTER_ADDR', 'localhost')}:"
            f"{os.environ.get('MASTER_PORT', '29500')}")
    else:
        num = num_processes if num_processes is not None else int(
            os.environ.get("SDVAR_NUM_PROCESSES", "1"))
        rank = process_id if process_id is not None else int(
            os.environ.get("SDVAR_PROCESS_ID", "0"))
        addr = coordinator_address or os.environ.get("SDVAR_COORDINATOR",
                                                     "localhost:1234")
    if num <= 1:
        return
    backend, why = backend_rule()
    if backend == "nccl":
        torch.cuda.set_device(rank_device())
    print(f"[distributed] rank {rank} of {num}: backend {backend} ({why}), "
          f"coordinator {addr}", flush=True)
    dist.init_process_group(backend, init_method=f"tcp://{addr}", rank=rank,
                            world_size=num, timeout=TIMEOUT)
    if backend != "gloo":
        _HOST_GROUP = dist.new_group(backend="gloo", timeout=TIMEOUT)


def shutdown() -> None:
    """Leave the process group (a no-op when not joined)."""
    global _HOST_GROUP
    if dist.is_initialized():
        dist.destroy_process_group()
    _HOST_GROUP = None


def host_group():
    """The group for host (CPU) tensors: the default group under gloo, a
    gloo group beside it under NCCL."""
    return _HOST_GROUP


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_master() -> bool:
    return get_rank() == 0


def is_local_master() -> bool:
    return local_rank() == 0 if dist.is_initialized() else True


def master_only(fn):
    """Run only on rank 0; other ranks get None."""

    @functools.wraps(fn)
    def wrapper(*a, **kw):
        if is_master():
            return fn(*a, **kw)
        return None

    return wrapper


def barrier() -> None:
    if get_world_size() > 1:
        dist.barrier(group=host_group())


def allgather_host(x: np.ndarray) -> np.ndarray:
    """Host arrays of one shape from every rank, stacked on axis 0 in rank
    order."""
    x = np.ascontiguousarray(x)
    if get_world_size() <= 1:
        return x[None]
    t = torch.from_numpy(x.copy())
    out = [torch.empty_like(t) for _ in range(get_world_size())]
    dist.all_gather(out, t, group=host_group())
    return np.stack([o.numpy() for o in out])


def allreduce_host(x: np.ndarray) -> np.ndarray:
    """Sum a small host array over the ranks."""
    if get_world_size() <= 1:
        return np.asarray(x)
    return allgather_host(np.asarray(x)).sum(axis=0)
