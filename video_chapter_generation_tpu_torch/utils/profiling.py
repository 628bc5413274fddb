"""Profiling helpers (counterpart of the JAX package's
utils/profiling.py): a torch.profiler trace of the host and the card
written for TensorBoard / Perfetto, named regions in it, and wall-clock
scopes."""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator


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


class Stopwatch:
    """Nested wall-clock scopes with a flat report.

    Copied from video_chapter_generation_tpu/utils/profiling.py:36."""

    def __init__(self):
        self.totals: Dict[str, float] = {}

    @contextlib.contextmanager
    def scope(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    def report(self) -> str:
        total = sum(self.totals.values()) or 1.0
        lines = [
            f"{name}: {t:.3f}s ({100 * t / total:.1f}%)"
            for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1])
        ]
        return "\n".join(lines)
