"""Frame-strip visualization of chapter timestamps
(video_frame_visualization/visualize.py:13-104, for the 1 fps frame-file
contract): the video's thumbnails as a grid, frame separators, and each
cut point's +-tolerance interval marked with alternating red (start) and
green (end) bars; predicted cut points in blue on the top half.

The port's own copy of video_chapter_generation_tpu/visualization/
frames.py (each definition names the line it was copied from), so the
port never imports the JAX package.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def video_thumbnails(corpus, vid: str, hw: int = 56) -> np.ndarray:
    """Load a video's 1 fps frames as uint8 [N, hw, hw, 3] thumbnails.

    Copied from video_chapter_generation_tpu/visualization/frames.py:18.
    """
    from ..data.frames import load_clip_frames

    n = corpus.image_num(vid)
    paths = [corpus.frame_path(vid, i) for i in range(1, n + 1)]
    return load_clip_frames(paths, hw)


def chapter_frame_strip(
    frames: np.ndarray,
    timestamps: Sequence[int],
    row_image_num: int = 65,
    tolerance: int = 3,
    pred_timestamps: Optional[Sequence[int]] = None,
):
    """frames: uint8 [N, h, w, 3] at 1 fps; timestamps in seconds.

    Returns a PIL.Image. GT cut intervals draw red/green alternating bars
    (reference behavior); optional predicted cut points draw blue bars on
    the top half, so GT and prediction are comparable in one strip.

    Copied from video_chapter_generation_tpu/visualization/frames.py:27.
    """
    from PIL import Image, ImageDraw

    frames = np.asarray(frames, np.uint8)
    n, ih, iw, ic = frames.shape

    marks = np.zeros(n, np.float32)
    for ts in timestamps:
        for idx in (round(ts - tolerance), round(ts + tolerance)):
            if 0 <= idx < n:
                marks[idx] = 1.0
    pred_marks = np.zeros(n, np.float32)
    for ts in pred_timestamps or ():
        idx = round(ts)
        if 0 <= idx < n:
            pred_marks[idx] = 1.0

    pad = (-n) % row_image_num
    if pad:
        frames = np.concatenate(
            [frames, np.zeros((pad, ih, iw, ic), np.uint8)]
        )
        marks = np.concatenate([marks, np.zeros(pad, np.float32)])
        pred_marks = np.concatenate([pred_marks, np.zeros(pad, np.float32)])
    col_num = len(frames) // row_image_num

    grid = frames.reshape(col_num, row_image_num, ih, iw, ic)
    rows = [np.concatenate(list(grid[r]), axis=1) for r in range(col_num)]
    scene = np.concatenate(rows, axis=0)

    img = Image.fromarray(scene)
    draw = ImageDraw.Draw(img)
    start = True
    i = 0
    for h in range(col_num):
        for w in range(row_image_num):
            x1 = w * iw + iw - 2
            draw.line((x1, h * ih, x1, (h + 1) * ih), fill=(0, 0, 0),
                      width=2)
            draw.line((w * iw, h * ih, (w + 1) * iw, h * ih),
                      fill=(255, 255, 255))
            if marks[i] >= 1.0:
                color = (255, 0, 0) if start else (0, 255, 0)
                draw.line((x1, h * ih, x1, (h + 1) * ih), fill=color,
                          width=4)
                start = not start
            if pred_marks[i] >= 1.0:
                draw.line((x1, h * ih, x1, h * ih + ih // 2),
                          fill=(0, 128, 255), width=4)
            i += 1
    return img
