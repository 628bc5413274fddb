"""Segment-model evaluation: per-video AUC/mAP, cut-point P/R/F, random
baseline, result files.

The port's own copy of video_chapter_generation_tpu/evalkit/segment_eval.py (the definitions the port uses;
each names the line it was copied from), so the port never imports
the JAX package.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..data.clip_grid import ClipInfo
from .boundary import calculate_pr, convert_clip_label2cut_point
from .metrics import average_precision_score, roc_auc_score


def group_clips_by_video(clips: Sequence[ClipInfo]) -> Dict[str, List[ClipInfo]]:
    """Copied from video_chapter_generation_tpu/evalkit/segment_eval.py:35."""
    out: Dict[str, List[ClipInfo]] = {}
    for c in clips:
        out.setdefault(c.vid, []).append(c)
    return out


def evaluate_segment_predictions(
    clips: Sequence[ClipInfo],
    clip_frame_num: int,
    max_offset: int = 2,
    rng: Optional[np.random.Generator] = None,
    compat_first_clip_double_count: bool = False,
) -> Dict:
    """clips must carry pred_score and pred_label. Returns the full metric
    dict + vid2cut_points mapping.

    compat_first_clip_double_count reproduces the reference's accumulation
    bug (each video's first clip counted twice,
    test_video_segment_point.py:287-295) for bit-parity with its published
    result files.

    Copied from video_chapter_generation_tpu/evalkit/segment_eval.py:42.
    """
    rng = rng or np.random.default_rng(123)
    per_video = group_clips_by_video(clips)
    if compat_first_clip_double_count:
        per_video = {vid: [v[0]] + v for vid, v in per_video.items()}

    auc_list, map_list = [], []
    acc: Dict[str, List[float]] = {k: [] for k in (
        "recall", "recall_3", "recall_5",
        "precision", "precision_3", "precision_5",
        "recall_rand", "recall_3_rand", "recall_5_rand",
        "precision_rand", "precision_3_rand", "precision_5_rand",
    )}
    vid2cut_points: Dict[str, Dict] = {}

    for vid, vclips in per_video.items():
        gt_labels = [c.clip_label for c in vclips]
        pred_scores = [c.pred_score for c in vclips]
        pred_labels = [c.pred_label for c in vclips]
        duration = vclips[-1].clip_start_end[1]
        gt_cut_points = vclips[-1].cut_points

        if 0 < sum(gt_labels) < len(gt_labels):
            auc_list.append(roc_auc_score(gt_labels, pred_scores))
            map_list.append(average_precision_score(gt_labels, pred_scores))

        second_gt = convert_clip_label2cut_point(
            gt_labels, clip_frame_num, max_offset
        )
        second_pred = convert_clip_label2cut_point(
            pred_labels, clip_frame_num, max_offset
        )
        second_rand = [
            int(rng.integers(0, duration)) for _ in range(len(gt_cut_points))
        ]
        vid2cut_points[vid] = {
            "second_gt_cut_points": second_gt,
            "second_pred_cut_points": second_pred,
        }

        if len(second_gt) == 0:
            continue
        r, r3, r5, p, p3, p5 = calculate_pr(second_gt, second_pred)
        acc["recall"].append(r)
        acc["recall_3"].append(r3)
        acc["recall_5"].append(r5)
        if p is not None:
            acc["precision"].append(p)
            acc["precision_3"].append(p3)
            acc["precision_5"].append(p5)

        r, r3, r5, p, p3, p5 = calculate_pr(second_gt, second_rand)
        acc["recall_rand"].append(r)
        acc["recall_3_rand"].append(r3)
        acc["recall_5_rand"].append(r5)
        if p is not None:
            acc["precision_rand"].append(p)
            acc["precision_3_rand"].append(p3)
            acc["precision_5_rand"].append(p5)

    def mean(xs):
        return float(np.mean(xs)) if xs else 0.0

    def fscore(p, r):
        return 2 * p * r / (p + r) if (p + r) > 0 else 0.0

    m = {k: mean(v) for k, v in acc.items()}
    result = {
        "mAP": mean(map_list),
        "AUC": mean(auc_list),
        "recall": m["recall"], "recall_3": m["recall_3"],
        "recall_5": m["recall_5"],
        "precision": m["precision"], "precision_3": m["precision_3"],
        "precision_5": m["precision_5"],
        "f1": fscore(m["precision"], m["recall"]),
        "f1_3": fscore(m["precision_3"], m["recall_3"]),
        "f1_5": fscore(m["precision_5"], m["recall_5"]),
        "recall_rand": m["recall_rand"],
        "recall_3_rand": m["recall_3_rand"],
        "recall_5_rand": m["recall_5_rand"],
        "precision_rand": m["precision_rand"],
        "precision_3_rand": m["precision_3_rand"],
        "precision_5_rand": m["precision_5_rand"],
        "f1_rand": fscore(m["precision_rand"], m["recall_rand"]),
        "f1_3_rand": fscore(m["precision_3_rand"], m["recall_3_rand"]),
        "f1_5_rand": fscore(m["precision_5_rand"], m["recall_5_rand"]),
        "vid2cut_points": vid2cut_points,
    }
    return result


def write_segment_result_files(result: Dict, result_file: str,
                               vid2cut_points_file: str) -> None:
    """Write the reference's exact txt format (test_video_segment_point.py
    :379-391) + vid2cut_points.json.

    Copied from video_chapter_generation_tpu/evalkit/segment_eval.py:146.
    """
    for path in (result_file, vid2cut_points_file):
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)

    with open(vid2cut_points_file, "w") as f:
        json.dump(result["vid2cut_points"], f)

    r = result
    with open(result_file, "w") as f:
        f.write(f"mAP {r['mAP']}\n")
        f.write(
            f"recall {r['recall']}, recall@3 {r['recall_3']}, "
            f"recall@5 {r['recall_5']}\n"
        )
        f.write(
            f"precision {r['precision']}, precision@3 {r['precision_3']}, "
            f"precision@5 {r['precision_5']}\n"
        )
        f.write(
            f"f-score {r['f1']}, f-score@3 {r['f1_3']}, "
            f"f-score@5 {r['f1_5']}\n"
        )
        f.write("\n")
        f.write(
            f"recall_rand {r['recall_rand']}, recall_rand@3 "
            f"{r['recall_3_rand']}, recall_rand@5 {r['recall_5_rand']}\n"
        )
        f.write(
            f"precision_rand {r['precision_rand']}, precision_rand@3 "
            f"{r['precision_3_rand']}, precision_rand@5 "
            f"{r['precision_5_rand']}\n"
        )
        f.write(
            f"f-score_rand {r['f1_rand']}, f-score_rand@3 {r['f1_3_rand']}, "
            f"f-score_rand@5 {r['f1_5_rand']}\n"
        )
