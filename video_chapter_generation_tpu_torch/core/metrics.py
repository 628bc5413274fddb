"""Metric logging: step timers + TensorBoard-style scalar writer.

The port's own copy of video_chapter_generation_tpu/core/metrics.py (every definition;
each names the line it was copied from), so the port never imports
the JAX package; StepTimer's spans, and the per-thread current timer
that the module's span() records on, are the port's own.
"""

from __future__ import annotations
import contextlib
import json
import os
import threading
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional


class MetricWriter:
    """add_scalar-compatible writer -> JSONL file (one record per scalar).

    Copied from video_chapter_generation_tpu/core/metrics.py:19.
    """

    def __init__(self, log_dir: str, filename: str = "scalars.jsonl"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, filename)
        self._f = open(self.path, "a", buffering=1)
        # real TensorBoard event files via the built-in writer
        from .tb_writer import TensorBoardWriter

        self._tb = TensorBoardWriter(log_dir)

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._f.write(
            json.dumps(
                {"tag": tag, "value": float(value), "step": int(step),
                 "time": time.time()}
            )
            + "\n"
        )
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()


class StepTimer:
    """Per-stage wall-clock accounting with items/sec rates, from any
    thread.

    Copied from video_chapter_generation_tpu/core/metrics.py:48, and
    grown into a span recorder: each thread keeps its own stack of open
    spans, so two threads can time one stage at once, and each span adds
    its self time (its length less that of the spans closed inside it on
    its thread) to its stage.
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.self_totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> List[_Open]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def start(self, stage: str) -> None:
        self._stack().append(_Open(stage, time.perf_counter()))

    def stop(self, stage: str, items: int = 1) -> float:
        """Close this thread's innermost open span of `stage` (KeyError if
        there is none) -> its seconds."""
        end = time.perf_counter()
        stack = self._stack()
        j = len(stack) - 1
        while j >= 0 and stack[j].stage != stage:
            j -= 1
        if j < 0:
            raise KeyError(stage)
        span = stack.pop(j)
        dt = end - span.t0
        if j > 0:
            stack[j - 1].children_s += dt
        with self._lock:
            self.totals[stage] += dt
            self.self_totals[stage] += dt - span.children_s
            self.counts[stage] += items
        return dt

    @contextlib.contextmanager
    def span(self, stage: str, items: int = 1) -> Iterator[None]:
        """start/stop around a block."""
        self.start(stage)
        try:
            yield
        finally:
            self.stop(stage, items)

    @contextlib.contextmanager
    def bind(self) -> Iterator["StepTimer"]:
        """Make this timer the calling thread's current one for the block:
        the module's span() records on it."""
        prev = current_timer()
        _current.timer = self
        try:
            yield self
        finally:
            _current.timer = prev

    def rate(self, stage: str) -> float:
        t = self.totals.get(stage, 0.0)
        return self.counts.get(stage, 0) / t if t > 0 else 0.0

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per stage: seconds, items, items_per_sec and self_seconds."""
        return {
            k: {"seconds": self.totals[k], "items": self.counts[k],
                "items_per_sec": self.rate(k),
                "self_seconds": self.self_totals[k]}
            for k in self.totals
        }


@dataclass
class _Open:
    """A span open on one thread's stack."""
    stage: str
    t0: float
    children_s: float = 0.0


_current = threading.local()


def current_timer() -> Optional[StepTimer]:
    """The timer bound to the calling thread (StepTimer.bind), or None."""
    return getattr(_current, "timer", None)


def span(stage: str, items: int = 1):
    """StepTimer.span on the calling thread's current timer; with none
    bound, a block that records nothing."""
    t = current_timer()
    return t.span(stage, items) if t is not None else \
        contextlib.nullcontext()
