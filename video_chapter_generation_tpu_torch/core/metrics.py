"""Metric logging: step timers + TensorBoard-style scalar writer.

The port's own copy of video_chapter_generation_tpu/core/metrics.py (every definition;
each names the line it was copied from), so the port never imports
the JAX package.
"""

from __future__ import annotations
import json
import os
import time
from collections import defaultdict
from typing import Dict, Optional


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
    """Per-stage wall-clock accounting with items/sec rates.

    Copied from video_chapter_generation_tpu/core/metrics.py:48.
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._start: Dict[str, float] = {}

    def start(self, stage: str) -> None:
        self._start[stage] = time.perf_counter()

    def stop(self, stage: str, items: int = 1) -> float:
        dt = time.perf_counter() - self._start.pop(stage)
        self.totals[stage] += dt
        self.counts[stage] += items
        return dt

    def rate(self, stage: str) -> float:
        t = self.totals.get(stage, 0.0)
        return self.counts.get(stage, 0) / t if t > 0 else 0.0

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"seconds": self.totals[k], "items": self.counts[k],
                "items_per_sec": self.rate(k)}
            for k in self.totals
        }
