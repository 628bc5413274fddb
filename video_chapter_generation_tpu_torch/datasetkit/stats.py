"""Dataset statistics (dataset_stats.py, clip_num.py, category_num.py).

The port's own copy of video_chapter_generation_tpu/datasetkit/stats.py
(each definition names the line it was copied from), so the port never
imports the JAX package. Computes the distributions the reference plots:
durations, chapters per video, chapter lengths, clips per video,
vocabulary size — as plain dicts (plotting is the caller's concern).
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Sequence

import numpy as np

from ..data.clip_grid import build_clip_grid
from .parsing import extract_first_timestamp


def video_stats(rows: Sequence[Dict]) -> Dict:
    """rows: [{vid, duration, timestamp_lines}].

    Copied from video_chapter_generation_tpu/datasetkit/stats.py:19.
    """
    durations = np.asarray([float(r.get("duration", 0)) for r in rows])
    chapters = np.asarray([len(r["timestamp_lines"]) for r in rows])
    chapter_lengths: List[float] = []
    for r in rows:
        secs = sorted(
            extract_first_timestamp(line)[0] for line in r["timestamp_lines"]
        )
        secs = [s for s in secs if s >= 0]
        bounds = secs + [float(r.get("duration", 0))]
        chapter_lengths += [
            b - a for a, b in zip(bounds, bounds[1:]) if b > a
        ]

    def describe(x):
        x = np.asarray(x, dtype=np.float64)
        if x.size == 0:
            return {}
        return {
            "count": int(x.size),
            "mean": float(x.mean()),
            "median": float(np.median(x)),
            "min": float(x.min()),
            "max": float(x.max()),
        }

    return {
        "num_videos": len(rows),
        "duration_sec": describe(durations),
        "chapters_per_video": describe(chapters),
        "chapter_length_sec": describe(chapter_lengths),
    }


def clips_per_video(rows: Sequence[Dict], clip_frame_num: int = 16,
                    max_offset: int = 2) -> Dict:
    """Copied from video_chapter_generation_tpu/datasetkit/stats.py:54."""
    counts = [
        len(build_clip_grid(int(r.get("duration", 0)), clip_frame_num,
                            max_offset))
        for r in rows
    ]
    return {
        "total_clips": int(np.sum(counts)),
        "mean_clips_per_video": float(np.mean(counts)) if counts else 0.0,
    }


def subtitle_vocab(corpus, max_videos: int = 1000) -> Counter:
    """Word frequency over subtitles (get_subtitle_vocab.py).

    Copied from video_chapter_generation_tpu/datasetkit/stats.py:67.
    """
    vocab: Counter = Counter()
    for vid in corpus.vids[:max_videos]:
        for sub in corpus.subtitles(vid):
            for w in sub["text"].lower().split():
                vocab[w] += 1
    return vocab
