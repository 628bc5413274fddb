"""What every kernel wrapper does around its C entry: the call on the
tensor's own device, and the count of launches.

The C entries launch on the current CUDA device and cache per-device
state (csrc/hopper_gemm.cuh, csrc/frame_ops.cu), so a tensor on cuda:1
with cuda:0 current would launch on the wrong card with another card's
stream. `on_device` makes the tensor's device current for the call (the
guard sets the device only where it differs). Kernels launch from one
host thread per card under the sharded scorers (pipeline/sharded.py),
so `count` adds under a lock: `wrapper.launches += 1` is a
read-modify-write that two threads could interleave.
"""

from __future__ import annotations

import threading
from typing import Callable

import torch

_count_lock = threading.Lock()


def on_device(fn: Callable[..., int], dev: torch.device, *args) -> int:
    """fn(*args, stream) with `dev` the current device and PyTorch's
    current stream on `dev` as the stream; returns fn's CUDA error code."""
    with torch.cuda.device(dev):
        return fn(*args, torch.cuda.current_stream(dev).cuda_stream)


def count(wrapper, attr: str = "launches") -> None:
    """Add one launch to wrapper.<attr>."""
    with _count_lock:
        setattr(wrapper, attr, getattr(wrapper, attr) + 1)
