"""Dataset filtering / cleaning utilities.

The port's own copy of video_chapter_generation_tpu/datasetkit/filtering.py
(each definition names the line it was copied from), so the port never
imports the JAX package: the reference's cleanup scripts
(dataset_filtering.py, remove_invalid_timestamp.py,
find_and_clean_bad_vid.py, remove_vids.py) as pure functions over the
parsed CSV rows. `find_bad_vids` takes the port's data/corpus.py
VideoCorpus.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from .parsing import extract_first_timestamp


def has_valid_timestamps(timestamp_lines: Sequence[str],
                         min_chapters: int = 2) -> bool:
    """A usable video needs >= min_chapters parseable, increasing
    timestamps (remove_invalid_timestamp.py semantics).

    Copied from video_chapter_generation_tpu/datasetkit/filtering.py:15.
    """
    secs = []
    for line in timestamp_lines:
        sec, _ = extract_first_timestamp(line)
        if sec < 0:
            return False
        secs.append(sec)
    if len(secs) < min_chapters:
        return False
    return all(b > a for a, b in zip(secs, secs[1:]))


def filter_videos(
    rows: Sequence[Dict],
    min_duration: float = 4 * 60,
    max_duration: float = 1800,
    min_chapters: int = 2,
    blacklist: Sequence[str] = (),
) -> Tuple[List[Dict], List[str]]:
    """Keep videos with valid increasing timestamps, duration in range and
    not blacklisted. rows: [{vid, duration, timestamp_lines, ...}].
    Returns (kept_rows, removed_vids).

    Copied from video_chapter_generation_tpu/datasetkit/filtering.py:30.
    """
    bl = set(blacklist)
    kept, removed = [], []
    for row in rows:
        vid = row["vid"]
        ok = (
            vid not in bl
            and min_duration <= float(row.get("duration", 0)) <= max_duration
            and has_valid_timestamps(row["timestamp_lines"], min_chapters)
        )
        (kept if ok else removed).append(row if ok else vid)
    return kept, removed


def find_bad_vids(corpus, min_frames: int = 16) -> List[str]:
    """Videos whose extracted frames are missing or too few
    (find_and_clean_bad_vid.py).

    Copied from video_chapter_generation_tpu/datasetkit/filtering.py:53.
    """
    bad = []
    for vid in corpus.vids:
        try:
            if corpus.image_num(vid) < min_frames:
                bad.append(vid)
        except Exception:
            bad.append(vid)
    return bad


def load_invalid_vids(path: str) -> List[str]:
    """Blacklist file: one vid per line (data/invalid_vids.txt).

    Copied from video_chapter_generation_tpu/datasetkit/filtering.py:66.
    """
    with open(path) as f:
        return [x.strip() for x in f if x.strip()]
