"""Process-level distribution on torch.distributed (counterpart of the
JAX package's parallel/dist.py:1-131): initialization, the process
index and count, and host-object collectives.

`initialize` joins a process group by address (`tcp://host:port`) or
from a launcher's environment (`RANK`, `WORLD_SIZE`, `MASTER_ADDR`,
`MASTER_PORT`, as `torchrun` sets them); with neither it does nothing
and every function here gives the single-process answer, as the JAX
functions do. The backend rule, logged by `initialize`: NCCL where every
process of the host has a card of its own (LOCAL_WORLD_SIZE <= the
card count), after making the process's card (LOCAL_RANK) current;
gloo on the CPU and where processes share a card (NCCL refuses two
ranks on one GPU); an explicit `backend` wins. Under NCCL the object
collectives move their bytes through the current card, so the process's
own card must be current when they run (`initialize` makes it so).

tests/test_torch_dist.py runs two spawned processes on gloo: by address
and by launcher environment, the object collectives and an all_reduce.
"""

from __future__ import annotations

import logging
import os
from typing import Any, List, Optional

import torch
import torch.distributed as tdist

logger = logging.getLogger(__name__)


def _initialized() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def choose_backend(local_count: int) -> str:
    """"nccl" where each of the host's `local_count` processes has a card
    of its own, else "gloo"."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return "nccl" if 0 < local_count <= cards else "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> bool:
    """Join the process group; True where this call made it (its caller
    then owns `shutdown`). coordinator_address ("host:port" or
    "tcp://host:port") needs num_processes and process_id; without it the
    launcher's environment is read; with neither, or when a group exists
    already, nothing happens (False)."""
    if _initialized():
        return False
    env = os.environ
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("initialize by address needs num_processes "
                             "and process_id")
        rank, world = int(process_id), int(num_processes)
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
    elif "RANK" in env and "WORLD_SIZE" in env:
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        init_method = "env://"
    else:
        return False
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_count = int(env.get("LOCAL_WORLD_SIZE", world))
    chosen = backend or choose_backend(local_count)
    if torch.cuda.is_available():
        # NCCL: the process's own card; gloo: the card it shares, so that
        # a collective on CUDA tensors finds its device current
        torch.cuda.set_device(local_rank if chosen == "nccl"
                              else local_rank % torch.cuda.device_count())
    logger.info("process %d of %d joins %s by %s (backend %s%s)", rank,
                world, init_method, "address" if coordinator_address
                else "environment", chosen, "" if backend else ", chosen")
    tdist.init_process_group(chosen, init_method=init_method,
                             world_size=world, rank=rank)
    return True


def shutdown() -> None:
    """Leave the process group (nothing without one)."""
    if _initialized():
        tdist.destroy_process_group()


def backend() -> Optional[str]:
    """The group's backend, or None without a group."""
    return tdist.get_backend() if _initialized() else None


def process_index() -> int:
    return tdist.get_rank() if _initialized() else 0


def process_count() -> int:
    return tdist.get_world_size() if _initialized() else 1


def local_rank() -> int:
    """This process's index on its host (LOCAL_RANK; else its rank)."""
    return int(os.environ.get("LOCAL_RANK", process_index()))


def local_count() -> int:
    """The processes of this host (LOCAL_WORLD_SIZE; else all)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", process_count()))


def is_primary() -> bool:
    """The process that writes checkpoints, logs and result files."""
    return process_index() == 0


def all_gather_object(obj: Any) -> List[Any]:
    """A picklable object from every process, in process order (objects
    of any pickled size)."""
    if process_count() == 1:
        return [obj]
    out: List[Any] = [None] * process_count()
    tdist.all_gather_object(out, obj)
    return out


def broadcast_object(obj: Any, root: int = 0) -> Any:
    """The root process's object, on every process (what the others pass
    is ignored)."""
    if process_count() == 1:
        return obj
    box = [obj if process_index() == root else None]
    tdist.broadcast_object_list(box, src=root)
    return box[0]


def barrier(name: str = "barrier") -> None:
    """Wait for every process. `name` names the barrier in the log (the
    JAX function's sync point name)."""
    if process_count() == 1:
        return
    logger.debug("barrier %s", name)
    if backend() == "nccl":
        tdist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        tdist.barrier()
