"""Seeded random weights, made on the device in a few large draws.

`make(shapes, seed, device, dtype_of)` draws one float32 normal buffer
per model part from a torch.Generator on `device` (seeded from the run's
seed and the part's index), cuts it into the state dict's tensors in key
order, scales each by its kind and casts it to the type it is served in.
The same call on the same kind of device gives the same tensors, so the
reference makes its own copy and never reads the program's.

Scales (the program's own convention for random weights, flax's
lecun-normal): matrix and convolution weights N(0, 1/fan_in); embedding
tables N(0, 1/width); the window attention's position bias N(0, 0.02^2);
norm and BatchNorm scales 1 + N(0, 0.05^2); biases and BatchNorm means
N(0, 0.02^2); BatchNorm variances 1 + |N(0, 0.1^2)|.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import torch

Shapes = Dict[str, Tuple[Tuple[int, ...], torch.dtype]]

_CHUNK = 1 << 28  # elements a draw


def shapes_of(module: torch.nn.Module) -> Shapes:
    """key -> (shape, dtype) of a module's state dict (a meta module is
    enough)."""
    return {k: (tuple(v.shape), v.dtype) for k, v in
            module.state_dict().items()}


def _scale(key: str, shape, x: torch.Tensor) -> torch.Tensor:
    """x ~ N(0, 1) of the tensor's shape -> the tensor's init."""
    if key.endswith("window_pos_bias"):
        return 0.02 * x
    if key.endswith("running_var"):
        return 1.0 + 0.1 * x.abs()
    if key.endswith(("bias", "running_mean")):
        return 0.02 * x
    if "embeddings." in key:
        return x * (1.0 / math.sqrt(shape[-1]))
    if len(shape) == 1 or (len(shape) == 2 and key.split(".")[-2].startswith(
            ("ln", "norm")) and "fusion_head" in key):
        return 1.0 + 0.05 * x  # a norm's scale (stacked: [W, dim])
    if len(shape) == 4:  # conv OIHW
        fan_in = shape[1] * shape[2] * shape[3]
    elif len(shape) == 3:  # a stacked dense [W, in, out]
        fan_in = shape[1]
    else:  # linear [out, in]
        fan_in = shape[1]
    return x * (1.0 / math.sqrt(fan_in))


def make(shapes: Shapes, seed: int, part: int, device,
         dtype_of: Callable[[str], torch.dtype]) -> Dict[str, torch.Tensor]:
    """The state dict of `shapes` from (seed, part) on device; floating
    entries in dtype_of(key), integer ones (BatchNorm counters) zero."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + 7919 * (part + 1)) % (1 << 63))
    keys = sorted(k for k, (_, dt) in shapes.items() if dt.is_floating_point)
    total = sum(math.prod(shapes[k][0]) for k in keys)
    out: Dict[str, torch.Tensor] = {}
    i = 0
    buf = torch.empty(0, device=device)
    start = 0
    for k in keys:
        shape = shapes[k][0]
        n = math.prod(shape)
        if i + n > buf.numel():  # the next draw: the rest, at most _CHUNK
            start += i
            take = max(n, min(_CHUNK, total - start))
            buf = torch.randn(take, generator=gen, device=device)
            i = 0
        x = buf[i:i + n].reshape(shape)
        i += n
        out[k] = _scale(k, shape, x).to(dtype_of(k))
    for k, (shape, dt) in shapes.items():
        if not dt.is_floating_point:
            out[k] = torch.zeros(shape, dtype=dt, device=device)
    return out


def as_float32(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The reference's copy: every floating tensor upcast to float32 (a
    bf16 weight keeps its exact value)."""
    return {k: v.float() if v.is_floating_point() else v
            for k, v in sd.items()}
