"""Profiling helpers (counterpart of the JAX package's
utils/profiling.py): a torch.profiler trace of the host and the card
written for TensorBoard / Perfetto, and named regions in it. Wall-clock
spans are core/metrics.py's StepTimer."""

from __future__ import annotations

import contextlib
from typing import Iterator


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[object]:
    """Capture a torch.profiler trace of the CPU and, where a card is
    present, CUDA activity; on exit it is written under log_dir as a
    Chrome trace (TensorBoard's profiler plugin reads the directory).
    Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named region visible in device traces."""
    from torch.profiler import record_function

    with record_function(name):
        yield

