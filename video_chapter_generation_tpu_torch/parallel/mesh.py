"""The device mesh of one process (counterpart of the JAX package's
parallel/mesh.py:1-111).

A `Mesh` is a 2-D grid of torch devices with the axes ("data",
"model"). The data axis carries batch sharding (pipeline/sharded.py);
the model axis is kept for tensor parallelism, and `shard_params_zero`
and `shard_params_tp` say which dim of each state-dict entry a ZeRO or a
tensor-parallel layout would split, by the JAX package's rules. The JAX
`--sharded` is one process over every local device; so is this mesh,
which needs no process group (torch.distributed's DeviceMesh needs one
per rank). A device may repeat: shards on one device run one after the
other there, with one replica of the model.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from . import dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
# shards of a --sharded run on the CPU (the tests): a CPU run goes through
# the split and the merge, as the JAX package's tests do on 8 virtual
# CPU devices
CPU_SHARDS = 2


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


@dataclass(frozen=True)
class Mesh:
    """devices[i][j]: the device of data shard i, model shard j."""
    devices: Tuple[Tuple[torch.device, ...], ...]
    axis_names: Tuple[str, str] = (DATA_AXIS, MODEL_AXIS)

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis_names[0]: len(self.devices),
                self.axis_names[1]: len(self.devices[0])}

    def data_devices(self) -> List[torch.device]:
        """The device each data shard runs on (its first model shard's)."""
        return [row[0] for row in self.devices]


def local_devices(device=None) -> List[torch.device]:
    """The devices a sharded run of this process serves over. A CUDA
    device with an index: that card. CUDA without one (the default):
    every card of the host for its only process; under a launcher with L
    processes on the host, local process r takes the cards r, r + L, ...
    (card r % N alone where L >= N cards). The CPU: CPU_SHARDS copies of
    it."""
    d = torch.device("cuda" if device is None else device)
    if d.type == "cpu":
        return [d] * CPU_SHARDS
    if d.type != "cuda" or d.index is not None:
        return [d]
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device: pass devices= (or --device cpu)")
    r, count = dist.local_rank(), dist.local_count()
    if count >= n:
        return [torch.device("cuda", r % n)]
    return [torch.device("cuda", i) for i in range(r, n, count)]


def make_mesh(data: int = -1, model: int = 1,
              devices: Optional[Sequence] = None,
              axis_names: Tuple[str, str] = (DATA_AXIS, MODEL_AXIS)
              ) -> Mesh:
    """A data x model mesh over `devices` (default: local_devices(), every
    card of this process) in order, row-major; data=-1 takes every
    device the model axis leaves."""
    devs = [_device(d) for d in (devices if devices is not None
                                 else local_devices())]
    n = len(devs)
    if data == -1:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model > n or data < 1 or model < 1:
        raise ValueError(f"mesh {data}x{model} > {n} devices")
    grid = tuple(tuple(devs[i * model:(i + 1) * model]) for i in range(data))
    return Mesh(grid, tuple(axis_names))


def local_batch_size(global_batch: int, mesh: Mesh) -> int:
    ndata = mesh.shape[DATA_AXIS]
    if global_batch % ndata:
        raise ValueError(f"global batch {global_batch} not divisible by data "
                         f"axis {ndata}")
    return global_batch // ndata


def shard_rows(mesh: Mesh, batch: Mapping[str, object]
               ) -> List[Dict[str, object]]:
    """Each data shard's rows of a host batch: dim 0 split into contiguous
    blocks in mesh order (P("data")), as they are (views, no copy).
    Raises ValueError where the data axis does not divide dim 0."""
    n = mesh.shape[DATA_AXIS]
    out: List[Dict[str, object]] = [{} for _ in range(n)]
    for k, v in batch.items():
        b = v.shape[0]
        if b % n:
            raise ValueError(f"batch dim {b} of '{k}' not divisible by data "
                             f"axis {n}; pick batch_size divisible by the "
                             f"data-axis size")
        per = b // n
        for i in range(n):
            out[i][k] = v[i * per:(i + 1) * per]
    return out


def shard_batch(mesh: Mesh, batch: Mapping[str, object]
                ) -> List[Dict[str, torch.Tensor]]:
    """shard_rows, each shard's tensors moved to its device."""
    return [{k: torch.as_tensor(v).to(d) for k, v in rows.items()}
            for rows, d in zip(shard_rows(mesh, batch), mesh.data_devices())]


def _numel(shape) -> int:
    return int(np.prod(shape, dtype=np.int64))


def shard_params_zero(mesh: Mesh, state: Mapping[str, object],
                      min_size: int = 2**14) -> Dict[str, Optional[int]]:
    """ZeRO-like layout of optimizer state or replicated parameters
    (JAX mesh.py:52-71): for each entry the largest dim that the data
    axis divides (the first of equal ones), None (replicated) for a
    scalar, an entry under min_size elements or one with no such dim.
    Shapes are read as given (the port's layouts)."""
    ndata = mesh.shape[DATA_AXIS]

    def dim_for(x) -> Optional[int]:
        shape = tuple(getattr(x, "shape", ()))
        if not shape or _numel(shape) < min_size:
            return None
        for ax in sorted(range(len(shape)), key=lambda i: -shape[i]):
            if shape[ax] % ndata == 0:
                return ax
        return None

    return {k: dim_for(v) for k, v in state.items()}


def shard_params_tp(mesh: Mesh, state: Mapping[str, object],
                    min_size: int = 2**12) -> Dict[str, Optional[int]]:
    """Tensor-parallel layout over the model axis (JAX mesh.py:74-95): the
    last dim of each entry of 2 or more dims and min_size elements, else
    the first dim that the model axis divides into parts of at least 2;
    None (replicated) otherwise and with a model axis of 1."""
    nmodel = mesh.shape[MODEL_AXIS]

    def dim_for(x) -> Optional[int]:
        shape = tuple(getattr(x, "shape", ()))
        if len(shape) < 2 or _numel(shape) < min_size or nmodel == 1:
            return None
        for ax in (len(shape) - 1, *range(len(shape) - 1)):
            if shape[ax] % nmodel == 0 and shape[ax] >= 2 * nmodel:
                return ax
        return None

    return {k: dim_for(v) for k, v in state.items()}


def batch_sharding(mesh: Mesh):
    """The data-axis layout of a batch (JAX P("data")): a function from a
    host batch to each shard's batch on its device (shard_batch)."""
    return lambda batch: shard_batch(mesh, batch)


def replicated(mesh: Mesh):
    """The replicated layout (JAX P()): a function from a tensor to one
    copy on each distinct device of the data axis, {device: tensor}."""
    return lambda t: {d: torch.as_tensor(t).to(d)
                      for d in dict.fromkeys(mesh.data_devices())}


@contextmanager
def use_mesh(mesh: Mesh):
    """`with use_mesh(mesh)` as in the JAX package; the port has no
    ambient mesh (each sharded function takes its mesh), so this yields
    it."""
    yield mesh
