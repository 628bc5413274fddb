"""Paper-statistics-matched subsampling (dataset_filtering.py:8-190).

The port's own copy of video_chapter_generation_tpu/datasetkit/sampler.py
(each definition names the line it was copied from), so the port never
imports the JAX package. Per category, draw video subsets without
replacement until the sampled statistics (avg chapter duration,
chapters/video, words/chapter) land within an error band of the paper's
published targets; the band widens from 5% to 10% after max_attempts,
like the reference. The draws come from the sampler's own seeded
random.Random, so a seed gives the JAX copy's sample.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence

from .parsing import clean_str, extract_first_timestamp

STAT_KEYS = ("avg_chapter_duration", "avg_chapters_per_video",
             "avg_words_per_chapter")


def stats_for_videos(video_ids: Sequence[str], vid2row: Dict[str, Dict]) -> Dict:
    """The reference's per-category statistics
    (dataset_filtering.py:34-88). vid2row maps vid ->
    {duration, timestamp_lines}.

    Copied from video_chapter_generation_tpu/datasetkit/sampler.py:20.
    """
    durations: List[float] = []
    chapter_nums: List[int] = []
    chapter_word_nums: List[int] = []
    for vid in video_ids:
        row = vid2row[vid]
        lines = row["timestamp_lines"]
        durations.append(float(row["duration"]))
        chapter_nums.append(len(lines))
        words = 0
        for line in lines:
            _, description = extract_first_timestamp(line)
            words += len(clean_str(description).split(" "))
        chapter_word_nums.append(words)
    total_chapters = sum(chapter_nums)
    return {
        "video_count": len(video_ids),
        "avg_chapter_duration": round(sum(durations) / total_chapters, 2),
        "avg_chapters_per_video": round(total_chapters / len(video_ids), 2),
        "avg_words_per_chapter": round(
            sum(chapter_word_nums) / total_chapters, 2
        ),
    }


def stats_in_range(sampled: Dict, target: Dict, error_range: float) -> bool:
    """dataset_filtering.py:22-33 (video_count excluded).

    Copied from video_chapter_generation_tpu/datasetkit/sampler.py:48.
    """
    for k, tv in target.items():
        if k == "video_count":
            continue
        if abs(sampled[k] - tv) / tv > error_range:
            return False
    return True


class DatasetSampler:
    """category -> sampled vid list matching the paper's stats.

    category2vid: {category: [vid, ...]}; target_stats:
    {category: {video_count, avg_chapter_duration, ...}}; vid2row as in
    stats_for_videos. keep_all_categories are taken whole (the reference
    special-cases "Category:Youth").

    Copied from video_chapter_generation_tpu/datasetkit/sampler.py:58.
    """

    def __init__(self, category2vid: Dict[str, List[str]],
                 target_stats: Dict[str, Dict], vid2row: Dict[str, Dict],
                 keep_all_categories: Sequence[str] = ("Category:Youth",),
                 max_attempts: int = 500, seed: Optional[int] = None):
        self.category2vid = category2vid
        self.target_stats = target_stats
        self.vid2row = vid2row
        self.keep_all = set(keep_all_categories)
        self.max_attempts = max_attempts
        self.rng = random.Random(seed)
        self.sampled_videos: Dict[str, List[str]] = {}
        self.sampled_stats: Dict[str, Dict] = {}

    def sample_category(self, category: str) -> bool:
        target = self.target_stats[category]
        available = self.category2vid[category]
        if category in self.keep_all:
            self.sampled_videos[category] = list(available)
            self.sampled_stats[category] = stats_for_videos(
                available, self.vid2row
            )
            return True
        if target["video_count"] > len(available):
            return False
        # two passes like the reference: 5% band, then a 10% band
        for error_range in (0.05, 0.1):
            for _ in range(self.max_attempts):
                sampled = self.rng.sample(available, target["video_count"])
                stats = stats_for_videos(sampled, self.vid2row)
                if stats_in_range(stats, target, error_range):
                    self.sampled_videos[category] = sampled
                    self.sampled_stats[category] = stats
                    return True
        return False

    def sample_all_categories(self) -> int:
        return sum(
            1 for c in self.target_stats if self.sample_category(c)
        )

    def save_results(self, video_file: str, stats_file: str) -> None:
        import json

        with open(video_file, "w") as f:
            json.dump(self.sampled_videos, f, indent=4)
        with open(stats_file, "w") as f:
            json.dump(self.sampled_stats, f, indent=4)
