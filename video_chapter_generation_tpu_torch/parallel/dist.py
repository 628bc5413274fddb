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

The collectives of data-parallel training (train/loop.py): a
`MomentGroup` is the process group over which BatchNorm takes its batch
moments; `use_moments(group)` makes it the one every BatchNorm site of
the port reads (`moment_group()`), from its plain version
(ops/tsm_block_train.py:bn_train, through the differentiable
`all_reduce_sum`) to the training kernels K11-K13, whose entries stop at
each moment for the wrapper to reduce it on the card's current stream.
With no group, or a group of one process, every site runs as alone.
`data_groups` splits the processes along the mesh's model axis.

tests/test_torch_dist.py runs two spawned processes on gloo: by address
and by launcher environment, the object collectives and an all_reduce;
tests/test_torch_ddp.py the training collectives.
"""

from __future__ import annotations

import logging
import os
from typing import Any, List, Optional, Tuple

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


def default_device() -> torch.device:
    """The card of this process (initialize made it current: its own
    under NCCL, the one it shares under gloo)."""
    return torch.device("cuda", torch.cuda.current_device())


def data_coords(model_axis: int = 1) -> Tuple[int, int]:
    """(index, count) of this process on the data axis of a (data, model)
    mesh over every process (data_groups); (0, 1) alone."""
    world = process_count()
    if world == 1:
        return 0, 1
    if model_axis < 1 or world % model_axis:
        raise ValueError(f"mesh.model_axis={model_axis} does not divide "
                         f"{world} processes")
    return process_index() // model_axis, world // model_axis


def data_groups(model_axis: int = 1) -> Tuple[Any, Any, int, int]:
    """(group, host_group, index, count) of this process on the data axis
    of a (data, model) mesh over every process, row-major as the JAX mesh
    (process r = data index r // model_axis, model index r % model_axis):
    the processes of its model index, which take disjoint rows and reduce
    gradients and moments together (None: the world, where model_axis is
    1), the same processes on gloo for host integers (the group itself
    under gloo), this process's place among them and their number.
    Collective: every process calls it. Alone: (None, None, 0, 1)."""
    if process_count() == 1:
        return None, None, 0, 1
    index, count = data_coords(model_axis)
    world, rank = process_count(), process_index()
    gloo = backend() == "gloo"
    mine = (None, None)
    for j in range(model_axis):
        ranks = None if model_axis == 1 else list(range(j, world,
                                                        model_axis))
        group = None if ranks is None else tdist.new_group(ranks)
        host = group if gloo else tdist.new_group(ranks, backend="gloo")
        if j == rank % model_axis:
            mine = (group, host)
    return (*mine, index, count)


class MomentGroup:
    """The processes whose rows make one batch for BatchNorm: each site
    sums its moments (sum, sum of squares) and its pixel count over them
    in the forward, and averages its backward moments (sum of the
    gradient, sum of the gradient times the centred input) over them.

    Why the average in the backward: each process differentiates its own
    mean loss L_r, and the gradients are averaged over the W processes
    (train/loop.py), which makes the gradient of L = mean_r L_r. Summed
    backward moments give each input the gradient of sum_r L_r = W L,
    which the parameter average divides by W again; but a BatchNorm's
    gamma and beta gradients come from those moments alone, equal on
    every process, and the average would leave them W times too large.
    Averaged moments with the count divided by W (`count_scales`) give
    the inputs the same gradient (the ratio of moment to count is
    unchanged) and gamma and beta that of L: the factor of W is taken
    here, once."""

    def __init__(self, group=None, host_group=None):
        """group: the processes (None: the world); host_group: the same
        processes on gloo, for the pixel counts, host integers reduced
        without a device round trip (data_groups makes both)."""
        self.group, self._host = group, host_group
        self.size = tdist.get_world_size(group)

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """t summed over the group, in place, ordered on t's card's
        current stream."""
        tdist.all_reduce(t, group=self.group)
        return t

    def mean_(self, t: torch.Tensor) -> torch.Tensor:
        """t averaged over the group, in place."""
        return self.sum_(t).div_(self.size)

    def count_scales(self, rows: int) -> Tuple[float, float]:
        """(forward, backward) count scales of a site whose local batch
        has `rows` frames: the group's frames over this process's, and
        that over the group size (1.0 where every process has as many)."""
        t = torch.tensor([rows], dtype=torch.int64)
        tdist.all_reduce(t, group=self._host)
        total = int(t)
        return total / rows, total / (rows * self.size)


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group, differentiable: the gradient of each process's
    input is the sum over the group of the gradients of the output (the
    derivative of sum_r L_r, whose per-process parts the trainer
    averages)."""

    @staticmethod
    def forward(ctx, t, mg):
        ctx.mg = mg
        return mg.sum_(t.clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.mg.sum_(g.contiguous().clone()), None


def all_reduce_sum(t: torch.Tensor, mg: MomentGroup) -> torch.Tensor:
    """t summed over the moment group, with a gradient (_AllReduceSum)."""
    return _AllReduceSum.apply(t, mg)


_MOMENTS: Optional[MomentGroup] = None


def moment_group() -> Optional[MomentGroup]:
    """The moment group BatchNorm sites reduce over; None alone. A module
    global, not a context variable: autograd runs the backward's sites on
    threads of its own."""
    return _MOMENTS


class use_moments:
    """`with use_moments(mg):` makes mg (None, or a group of one process:
    no group) the moment group for the block, and restores the one
    before."""

    def __init__(self, mg: Optional[MomentGroup]):
        self.mg = mg if mg is not None and mg.size > 1 else None

    def __enter__(self):
        global _MOMENTS
        self.before, _MOMENTS = _MOMENTS, self.mg
        return self.mg

    def __exit__(self, *exc):
        global _MOMENTS
        _MOMENTS = self.before
        return False


# elements of a flattened bucket of the training collectives (128 MiB of
# float32): few collectives a step, bounded extra memory
BUCKET = 1 << 25


def buckets(tensors):
    """tensors in runs of one dtype and device of at most BUCKET elements
    (a larger tensor alone), in order."""
    run, size = [], 0
    for t in tensors:
        if run and (t.dtype != run[0].dtype or t.device != run[0].device
                    or size + t.numel() > BUCKET):
            yield run
            run, size = [], 0
        run.append(t)
        size += t.numel()
    if run:
        yield run


def mean_tensors_(tensors, group=None) -> None:
    """Average each tensor over the group, in place: flattened into
    buckets of at most BUCKET elements, one all_reduce a bucket (the
    gradient reduction of data-parallel training)."""
    count = tdist.get_world_size(group)
    for run in buckets(list(tensors)):
        flat = torch.cat([t.reshape(-1) for t in run])
        tdist.all_reduce(flat, group=group)
        flat.div_(count)
        at = 0
        for t in run:
            t.copy_(flat[at:at + t.numel()].view_as(t))
            at += t.numel()
