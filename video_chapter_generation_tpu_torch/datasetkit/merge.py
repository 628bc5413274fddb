"""Dataset merge: per-category scrape outputs -> all_in_one_with_subtitle.csv
(youtube_dataset_all_in_one.py:15-127).

    python -m video_chapter_generation_tpu_torch.datasetkit.merge \
        --dataset_dir scrape/ --video_dir videos/ --out all_in_one.csv

The port's own copy of video_chapter_generation_tpu/datasetkit/merge.py
(each definition names the line it was copied from), so the port never
imports the JAX package. Stage contract: each category directory holds a
data.csv (videoId, title, timestamp) and subtitle_<vid>.json files;
downloaded videos live together under one directory. This builder reads
durations from the video files (cv2 CAP_PROP_FPS / CAP_PROP_FRAME_COUNT,
gated + injectable), applies the reference's quality filters, and writes
the single CSV every downstream stage consumes.

One difference from the JAX copy: `keep_video` drops a video of zero (or
negative) duration, where the JAX copy divides by it and raises
ZeroDivisionError (a 0-frame file that cv2 opens reads as 0.0 s).
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .acquire import timestamps_to_csv_cell
from .parsing import extract_first_timestamp, parse_csv_to_list

MAX_DURATION_SEC = 1800  # < 30 min        (youtube_dataset_all_in_one.py:82)
MIN_WORDS_PER_SEC = 0.5  # speech density  (:90)
MIN_CHAPTERS = 3  #                        (:92)


def video_duration(path: str) -> Optional[float]:
    """Duration in seconds via cv2 frame_count/fps
    (youtube_dataset_all_in_one.py:21-28); None for unreadable files
    (the reference deletes those). Gated on cv2.

    Copied from video_chapter_generation_tpu/datasetkit/merge.py:27.
    """
    try:
        import cv2  # type: ignore
    except ImportError as e:
        raise RuntimeError(
            "cv2 not installed — pass duration_fn= to "
            "collect_video_durations for offline use"
        ) from e
    cap = cv2.VideoCapture(path)
    fps = cap.get(cv2.CAP_PROP_FPS)
    if fps <= 0:
        return None
    return round(cap.get(cv2.CAP_PROP_FRAME_COUNT) / fps, 2)


def collect_video_durations(
    video_files: Sequence[str],
    n_workers: int = 8,
    duration_fn: Optional[Callable[[str], Optional[float]]] = None,
    remove_invalid: bool = False,
) -> Dict[str, float]:
    """vid -> duration over a thread fan-out
    (multiple_process_load_video, :15-33). Invalid files are skipped, and
    deleted when remove_invalid (the reference always deletes).

    Copied from video_chapter_generation_tpu/datasetkit/merge.py:45.
    """
    duration_fn = duration_fn or video_duration
    out: Dict[str, float] = {}

    def work(path):
        vid = os.path.basename(path).split(".")[0]
        d = duration_fn(path)
        if d is None:
            if remove_invalid:
                os.remove(path)
            return None
        return vid, d

    with ThreadPoolExecutor(n_workers) as ex:
        for r in ex.map(work, video_files):
            if r is not None:
                out[r[0]] = r[1]
    return out


def load_dataset_with_subtitle(
    asr_files: Sequence[str],
) -> Tuple[List[str], List[str], List[List[str]], List[List[Dict]]]:
    """(vids, titles, timestamp-line-lists, subtitles) for every
    subtitle_<vid>.json, joined against the sibling data.csv
    (load_dataset_utils.py:185-210).

    Copied from video_chapter_generation_tpu/datasetkit/merge.py:73.
    """
    vids, titles, stamps, subs = [], [], [], []
    csv_cache: Dict[str, Dict[str, int]] = {}
    csv_rows: Dict[str, Tuple] = {}
    for asr_file in asr_files:
        csv_file = os.path.join(os.path.dirname(asr_file), "data.csv")
        if csv_file not in csv_cache:
            cvids, ctitles, cstamps = parse_csv_to_list(csv_file,
                                                        w_duration=False)
            csv_cache[csv_file] = {v: i for i, v in enumerate(cvids)}
            csv_rows[csv_file] = (ctitles, cstamps)
        vid = os.path.basename(asr_file).split(".")[0][9:]  # subtitle_<vid>
        idx = csv_cache[csv_file].get(vid)
        if idx is None:
            continue
        with open(asr_file) as f:
            subtitle = json.load(f)
        ctitles, cstamps = csv_rows[csv_file]
        vids.append(vid)
        titles.append(ctitles[idx])
        stamps.append(cstamps[idx])
        subs.append(subtitle)
    return vids, titles, stamps, subs


def keep_video(duration: float, subtitle: Sequence[Dict],
               timestamp_lines: Sequence[str]) -> bool:
    """The reference's merge-time quality filters
    (youtube_dataset_all_in_one.py:80-97): <=30 min, >=0.5 words/sec of
    speech, >=3 chapters, first chapter at second 0. A video of no
    positive duration has no speech rate and is dropped (the JAX copy
    raises ZeroDivisionError at 0 s).

    Copied from video_chapter_generation_tpu/datasetkit/merge.py:103.
    """
    if duration > MAX_DURATION_SEC or duration <= 0:
        return False
    words = "".join(x["text"] for x in subtitle).split(" ")
    if len(words) / duration < MIN_WORDS_PER_SEC:
        return False
    if len(timestamp_lines) < MIN_CHAPTERS:
        return False
    sec, _ = extract_first_timestamp(timestamp_lines[0])
    return sec == 0


def combine_all_data_with_subtitle(
    asr_files: Sequence[str],
    vid2duration: Dict[str, float],
    out_csv: str,
) -> int:
    """Build all_in_one_with_subtitle.csv
    (combine_all_data_with_subtitle, :37-122). Returns #rows written.

    Copied from video_chapter_generation_tpu/datasetkit/merge.py:119.
    """
    import pandas as pd

    vids, titles, stamps, subs = load_dataset_with_subtitle(asr_files)
    rows: Dict[str, List] = {
        "videoId": [], "title": [], "duration": [], "timestamp": []
    }
    seen = set()
    for vid, title, timestamp, subtitle in zip(vids, titles, stamps, subs):
        if vid in seen or vid not in vid2duration:
            continue
        duration = vid2duration[vid]
        if not keep_video(duration, subtitle, timestamp):
            continue
        seen.add(vid)
        rows["videoId"].append(vid)
        rows["title"].append(title)
        rows["duration"].append(duration)
        rows["timestamp"].append(timestamps_to_csv_cell(timestamp))

    d = os.path.dirname(out_csv)
    if d:
        os.makedirs(d, exist_ok=True)
    pd.DataFrame(rows).to_csv(out_csv)
    return len(rows["videoId"])


def main(argv: Optional[List[str]] = None):
    """Copied from video_chapter_generation_tpu/datasetkit/merge.py:152."""
    import argparse
    import glob

    p = argparse.ArgumentParser(
        description="merge per-category scrapes into all_in_one CSV"
    )
    p.add_argument("--dataset_dir", required=True,
                   help="root holding <category>/data.csv + subtitle_*.json")
    p.add_argument("--video_dir", required=True, help="downloaded .mp4 dir")
    p.add_argument("--out", required=True)
    p.add_argument("--workers", type=int, default=8)
    args = p.parse_args(argv)

    asr_files = sorted(
        glob.glob(os.path.join(args.dataset_dir, "*", "subtitle_*.json"))
    )
    video_files = sorted(glob.glob(os.path.join(args.video_dir, "*.mp4")))
    vid2duration = collect_video_durations(video_files, args.workers)
    n = combine_all_data_with_subtitle(asr_files, vid2duration, args.out)
    print(f"wrote {n} rows to {args.out}")


if __name__ == "__main__":
    main()
