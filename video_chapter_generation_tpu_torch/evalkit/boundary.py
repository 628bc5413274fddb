"""Boundary-prediction metrics: label->cut-point conversion and P/R/F@0/3/5s.

The port's own copy of video_chapter_generation_tpu/evalkit/boundary.py (the definitions the port uses;
each names the line it was copied from), so the port never imports
the JAX package.
"""

from __future__ import annotations
from typing import List, Sequence


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
