"""Device resolution: an explicit device for every entry point."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """`None` means the card: CUDA, or an error where there is none. The
    CPU is only ever what a caller names (`--device cpu`, the tests), so a
    machine without a GPU never runs an entry point on the CPU unasked.
    The current CUDA device is left as it is: each kernel wrapper makes
    its tensor's card current for its launch (ops/_calls.py)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available"
            + (" (the default is the card; pass --device cpu, or "
               "device='cpu', to run on the CPU)" if device is None else ""))
    return dev
