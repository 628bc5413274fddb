"""Boundary-prediction metrics: label->cut-point conversion and P/R/F@0/3/5s.

The port's own copy of video_chapter_generation_tpu/evalkit/boundary.py (the definitions the port uses;
each names the line it was copied from), so the port never imports
the JAX package.
"""

from __future__ import annotations
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def convert_clip_label2cut_point(
    clip_label_array: Sequence[int], clip_frame_num: int, max_offset: int
) -> List[int]:
    """Collapse each maximal run of positive clips to a single cut point.

    The cut point is the rounded midpoint of the run's covered time span
    (run start clip's start sec .. last positive clip's end sec), matching
    eval_utils.py:3-18 including the `-1` in the midpoint and banker's
    rounding via python round().


    Copied from video_chapter_generation_tpu/evalkit/boundary.py:16.
    """
    enter = False
    begin_sec = 0
    cut_points: List[int] = []
    for i in range(len(clip_label_array)):
        if clip_label_array[i] == 1 and not enter:
            enter = True
            begin_sec = i * max_offset * 2
        if clip_label_array[i] == 0 and enter:
            enter = False
            end_sec = (i - 1) * max_offset * 2 + clip_frame_num
            cut_points.append(round((begin_sec + end_sec - 1) / 2))
    return cut_points


def calculate_pr(
    gt_cut_points: Sequence[int], pred_cut_points: Sequence[int]
) -> Tuple[float, float, float, Optional[float], Optional[float], Optional[float]]:
    """Recall and precision at exact / ±3 s / ±5 s tolerance.

    Precision values are None when there are no predictions
    (eval_utils.py:21-92). Recall raises ZeroDivisionError on empty GT like
    the reference; callers filter videos with no GT cut points.

    Copied from video_chapter_generation_tpu/evalkit/boundary.py:40.
    """
    tp = tp3 = tp5 = 0
    for g in gt_cut_points:
        hit = any(g == p for p in pred_cut_points)
        hit3 = any(g - 3 <= p <= g + 3 for p in pred_cut_points)
        hit5 = any(g - 5 <= p <= g + 5 for p in pred_cut_points)
        tp += hit
        tp3 += hit3
        tp5 += hit5
    n_gt = len(gt_cut_points)
    recall = tp / n_gt
    recall_3 = tp3 / n_gt
    recall_5 = tp5 / n_gt

    precision = precision_3 = precision_5 = None
    if len(pred_cut_points) > 0:
        tpp = tpp3 = tpp5 = 0
        for p in pred_cut_points:
            hit = any(p == g for g in gt_cut_points)
            hit3 = any(g - 3 <= p <= g + 3 for g in gt_cut_points)
            hit5 = any(g - 5 <= p <= g + 5 for g in gt_cut_points)
            tpp += hit
            tpp3 += hit3
            tpp5 += hit5
        n_pred = len(pred_cut_points)
        precision = tpp / n_pred
        precision_3 = tpp3 / n_pred
        precision_5 = tpp5 / n_pred

    return recall, recall_3, recall_5, precision, precision_3, precision_5


def f1(precision: float, recall: float) -> float:
    """Copied from video_chapter_generation_tpu/evalkit/boundary.py:80."""
    if precision + recall == 0:
        return 0.0
    return 2 * precision * recall / (precision + recall)


def aggregate_pr_over_videos(
    per_video: Sequence[Tuple[Sequence[int], Sequence[int]]],
) -> Dict[str, float]:
    """Mean recall/precision/F1 over videos, skipping None precisions,
    mirroring the accumulation in test_video_segment_point.py:309-345.

    Copied from video_chapter_generation_tpu/evalkit/boundary.py:86.
    """
    recalls, recalls3, recalls5 = [], [], []
    precisions, precisions3, precisions5 = [], [], []
    for gt, pred in per_video:
        if len(gt) == 0:
            continue
        r, r3, r5, p, p3, p5 = calculate_pr(gt, pred)
        recalls.append(r)
        recalls3.append(r3)
        recalls5.append(r5)
        if p is not None:
            precisions.append(p)
            precisions3.append(p3)
            precisions5.append(p5)

    def mean(xs):
        return float(np.mean(xs)) if xs else 0.0

    out = {
        "recall": mean(recalls),
        "recall_3s": mean(recalls3),
        "recall_5s": mean(recalls5),
        "precision": mean(precisions),
        "precision_3s": mean(precisions3),
        "precision_5s": mean(precisions5),
    }
    out["f1"] = f1(out["precision"], out["recall"])
    out["f1_3s"] = f1(out["precision_3s"], out["recall_3s"])
    out["f1_5s"] = f1(out["precision_5s"], out["recall_5s"])
    return out


def random_guess_cut_points(
    num_clips: int,
    pos_ratio: float,
    clip_frame_num: int,
    max_offset: int,
    rng: np.random.Generator,
) -> List[int]:
    """Random-baseline predictions: label each clip positive with the dataset
    positive ratio, then convert (test_video_segment_point.py:346-357).

    Copied from video_chapter_generation_tpu/evalkit/boundary.py:122.
    """
    labels = (rng.random(num_clips) < pos_ratio).astype(np.int32)
    return convert_clip_label2cut_point(list(labels), clip_frame_num, max_offset)
