"""Train/val/test split of the all-in-one CSV, and the easy/hard and
subset splits.

    python -m video_chapter_generation_tpu_torch.datasetkit.split \
        --data_file all_in_one.csv --out_dir dataset/

The port's own copy of video_chapter_generation_tpu/datasetkit/split.py
(each definition names the line it was copied from), so the port never
imports the JAX package: split_dataset.py:14-58 (fixed seed 123, shuffle
the vid list, 70/10/20 split, one vid per line), the human-label and
ROUGE easy/hard splits and the seeded subsets.

One difference from the JAX copy: `main` writes an empty file for an
empty split, where the JAX copy writes "\\n" (read back line by line, one
empty vid id). A split with vids is written byte for byte as there.
"""

from __future__ import annotations

import argparse
import os
import random
from typing import List, Optional

from .parsing import parse_csv_to_list


def split_vids(vids: List[str], seed: int = 123,
               ratios=(0.7, 0.1, 0.2)):
    """Copied from video_chapter_generation_tpu/datasetkit/split.py:20."""
    rng = random.Random(seed)
    vids = list(vids)
    rng.shuffle(vids)
    n = len(vids)
    n_train = int(n * ratios[0])
    n_val = int(n * ratios[1])
    return (
        vids[:n_train],
        vids[n_train : n_train + n_val],
        vids[n_train + n_val :],
    )


def main(argv: Optional[List[str]] = None):
    """Copied from video_chapter_generation_tpu/datasetkit/split.py:35 (an
    empty split is an empty file)."""
    p = argparse.ArgumentParser()
    p.add_argument("--data_file", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--seed", type=int, default=123)
    args = p.parse_args(argv)

    vids, *_ = parse_csv_to_list(args.data_file)
    train, val, test = split_vids(vids, args.seed)
    os.makedirs(args.out_dir, exist_ok=True)
    for name, split in (("train", train), ("val", val), ("test", test)):
        path = os.path.join(args.out_dir, f"{name}.txt")
        with open(path, "w") as f:
            f.write("".join(f"{vid}\n" for vid in split))
        print(f"{name}: {len(split)} vids -> {path}")


def split_easy_hard_from_labels(label_csv: str):
    """split_easy_hard_dataset.py: bucket vids by human annotation. The
    second annotator's label overrides the first when present; labels:
    2=easy, 1=hard, 0=ambiguous, -1=wrong data. Returns
    (easy, hard, ambiguous, wrong) vid lists.

    Copied from video_chapter_generation_tpu/datasetkit/split.py:56.
    """
    import math

    import pandas as pd

    data = pd.read_csv(label_csv)
    buckets = {2: [], 1: [], 0: [], -1: []}
    for vid, r1, r2 in zip(data["object id"], data["1_label_result"],
                           data["2_label_result"]):
        label = r1 if (isinstance(r2, float) and math.isnan(r2)) else r2
        if int(label) in buckets:
            buckets[int(label)].append(vid)
    return buckets[2], buckets[1], buckets[0], buckets[-1]


def intersect_split(test_vids: List[str], easy_vids: List[str],
                    hard_vids: List[str]):
    """split_easy_hard_testing_vids.py: intersect the test list with
    manually-labeled easy/hard vid lists.

    Copied from video_chapter_generation_tpu/datasetkit/split.py:75.
    """
    easy_set, hard_set = set(easy_vids), set(hard_vids)
    return (
        [v for v in test_vids if v in easy_set],
        [v for v in test_vids if v in hard_set],
    )


def subset_split(vids: List[str], fraction: float, seed: int = 42):
    """Seeded fractional subset of a vid list, sorted for stable output.

    Port of the reference's subsetting one-offs: reduce_val_data.py:19-25
    (random.sample(ids, int(len*frac)) at seed 42, written sorted) and the
    debugging-ID sampling in make_temp_dataset.py:28-31.

    Copied from video_chapter_generation_tpu/datasetkit/split.py:86.
    """
    rng = random.Random(seed)
    sample_size = int(len(vids) * fraction)
    return sorted(rng.sample(list(vids), sample_size))


def filter_clips_to_vids(clips: List[dict], vids: List[str]) -> List[dict]:
    """Keep only flattened-clip records whose 'vid' is in the subset
    (reduce_val_data.py:32).

    Copied from video_chapter_generation_tpu/datasetkit/split.py:97.
    """
    keep = set(vids)
    return [c for c in clips if c["vid"] in keep]


def rouge_upper_bound_split(corpus, threshold: float = 0.25):
    """Automatic easy/hard criterion: a video is 'easy' when its chapter
    titles are extractable from the subtitles — the mean best-window
    ROUGE-1 F upper bound over its chapters exceeds the threshold
    (calculate_rouge_score_for_chapter_summary.py analogue). corpus: the
    port's data/corpus.py VideoCorpus.

    Copied from video_chapter_generation_tpu/datasetkit/split.py:104.
    """
    from ..data.clip_grid import chapter_spans
    from ..data.datasets import _chapter_text, _clean_title
    from ..evalkit.rouge import rouge_scores
    from ..evalkit.title_eval import principal_baseline

    easy, hard = [], []
    for vid in corpus.vids:
        chapters = corpus.chapter_descriptions(vid)
        duration = round(corpus.records[vid].duration - 1)
        spans = chapter_spans([c[0] for c in chapters], duration)
        scores = []
        for (start, end), (_, desc) in zip(spans, chapters):
            title = _clean_title(desc)
            text = _chapter_text(corpus.subtitles(vid), start, end)
            if not title or not text:
                continue
            best = principal_baseline(text)
            scores.append(rouge_scores(best, title)["rouge-1"]["f"])
        mean = sum(scores) / len(scores) if scores else 0.0
        (easy if mean >= threshold else hard).append(vid)
    return easy, hard


if __name__ == "__main__":
    main()
