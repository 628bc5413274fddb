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


# the tsm_impl values whose inference route is plain torch (models/
# resnet.py:eval_route), so a re-entry through it differentiates
DIFFERENTIABLE_EVAL_IMPLS = ("tap3", "xla")


def refuse_grad(name: str, x: torch.Tensor) -> None:
    """An inference kernel writes its output through a pointer, which
    autograd cannot see: raise NotImplementedError where grad mode is on
    and the activation x requires a gradient, rather than return an output
    cut off from the graph or give way to the plain version unasked (the
    weights, folded under no_grad, never do)."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError(
            f"{name} has no backward: its inference kernel does not take a "
            f"gradient. To differentiate a ResNet re-entry (from_stage, "
            f"Grad-CAM) on the card, use tsm_impl "
            f"{' or '.join(map(repr, DIFFERENTIABLE_EVAL_IMPLS))}, whose "
            f"inference route is plain torch")
