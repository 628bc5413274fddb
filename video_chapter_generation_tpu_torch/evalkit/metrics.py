"""Ranking metrics (ROC-AUC, average precision) in pure numpy.

The port's own copy of video_chapter_generation_tpu/evalkit/metrics.py (the definitions the port uses;
each names the line it was copied from), so the port never imports
the JAX package.
"""

from __future__ import annotations
from typing import Sequence
import numpy as np


def roc_auc_score(y_true: Sequence[int], y_score: Sequence[float]) -> float:
    """Area under the ROC curve via the Mann-Whitney U statistic
    (tie-aware rank formulation — identical to sklearn's trapezoid AUC).


    Copied from video_chapter_generation_tpu/evalkit/metrics.py:16.
    """
    y_true = np.asarray(y_true)
    y_score = np.asarray(y_score, dtype=np.float64)
    n_pos = int(np.sum(y_true == 1))
    n_neg = int(np.sum(y_true == 0))
    if n_pos == 0 or n_neg == 0:
        raise ValueError("roc_auc_score requires both classes present")
    order = np.argsort(y_score, kind="mergesort")
    ranks = np.empty(len(y_score), dtype=np.float64)
    sorted_scores = y_score[order]
    # average ranks for ties
    i = 0
    while i < len(sorted_scores):
        j = i
        while j + 1 < len(sorted_scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i : j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    sum_pos_ranks = float(np.sum(ranks[y_true == 1]))
    return (sum_pos_ranks - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg)


def average_precision_score(
    y_true: Sequence[int], y_score: Sequence[float]
) -> float:
    """AP = sum_n (R_n - R_{n-1}) * P_n over the PR curve at each threshold,
    matching sklearn's step-wise (non-interpolated) definition.


    Copied from video_chapter_generation_tpu/evalkit/metrics.py:40.
    """
    y_true = np.asarray(y_true)
    y_score = np.asarray(y_score, dtype=np.float64)
    n_pos = int(np.sum(y_true == 1))
    if n_pos == 0:
        raise ValueError("average_precision_score requires positive samples")

    desc = np.argsort(-y_score, kind="mergesort")
    y_true = y_true[desc]
    y_score = y_score[desc]

    # threshold boundaries: last index of each distinct score
    distinct = np.where(np.diff(y_score))[0]
    threshold_idxs = np.concatenate([distinct, [len(y_score) - 1]])

    tps = np.cumsum(y_true)[threshold_idxs].astype(np.float64)
    fps = (threshold_idxs + 1) - tps
    precision = tps / (tps + fps)
    recall = tps / n_pos

    # prepend recall 0
    recall_prev = np.concatenate([[0.0], recall[:-1]])
    return float(np.sum((recall - recall_prev) * precision))
