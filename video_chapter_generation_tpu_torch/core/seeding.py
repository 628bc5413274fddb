"""Deterministic RNG plumbing.

The port's own copy of video_chapter_generation_tpu/core/seeding.py (the definitions the port uses;
each names the line it was copied from), so the port never imports
the JAX package.
"""

from __future__ import annotations
import random
import numpy as np


DEFAULT_SEED = 123


def host_rng(seed: int = DEFAULT_SEED, *streams: int) -> np.random.Generator:
    """An independent numpy Generator for a named stream hierarchy, e.g.
    host_rng(123, epoch, worker_id).

    Copied from video_chapter_generation_tpu/core/seeding.py:25.
    """
    return np.random.default_rng(np.random.SeedSequence((seed, *streams)))
