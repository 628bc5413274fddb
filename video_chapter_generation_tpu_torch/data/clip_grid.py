"""Clip-grid construction, IoU labeling, frame indexing and subtitle windows.

The port's own copy of video_chapter_generation_tpu/data/clip_grid.py (the definitions the port uses;
each names the line it was copied from), so the port never imports
the JAX package.
"""

from __future__ import annotations
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple
import numpy as np


DEFAULT_MAX_OFFSET = 2


TEXT_EXTRA_TIME_GAP = 1


def valid_cut_points(
    raw_secs: Sequence[int],
    image_num: int,
    fps: int = 1,
    mode: str = "train",
) -> List[int]:
    """Filter G.T. chapter starts to those usable as boundary labels.

    mode="train" keeps sec in [4, image_num]   (youtube_dataset.py:82-87)
    mode="infer" keeps sec in [4, image_num-4] (flat_video2clip...py:53-56)


    Copied from video_chapter_generation_tpu/data/clip_grid.py:32.
    """
    lo = 4 * fps
    hi = image_num if mode == "train" else image_num - 4 * fps
    out = []
    for sec in raw_secs:
        if sec < lo:
            continue
        if sec > hi:
            continue
        out.append(sec)
    return out


def build_clip_grid(
    image_num: int, clip_frame_num: int, max_offset: int = DEFAULT_MAX_OFFSET
) -> List[Tuple[int, int]]:
    """Slide a clip window over the video timeline.

    ``range(0, image_num - clip_frame_num, 2*max_offset)`` — note the
    exclusive stop, so the final clip always satisfies end <= image_num.


    Copied from video_chapter_generation_tpu/data/clip_grid.py:55.
    """
    return [
        (start_t, start_t + clip_frame_num)
        for start_t in range(0, image_num - clip_frame_num, 2 * max_offset)
    ]


def clip_iou_with_cut_point(
    clip_start: int, clip_end: int, cut_point: int, half_clip_frame_num: int
) -> float:
    """IoU between a clip and the window centered on a cut point.

    Copied from video_chapter_generation_tpu/data/clip_grid.py:69.
    """
    pos_st = cut_point - half_clip_frame_num
    pos_et = cut_point + half_clip_frame_num
    a = max(clip_start, pos_st)
    mi = min(clip_start, pos_st)
    b = min(clip_end, pos_et)
    ma = max(clip_end, pos_et)
    return (b - a) / (ma - mi)


def label_clips(
    clips: Sequence[Tuple[int, int]],
    cut_points: Sequence[int],
    clip_frame_num: int,
    max_offset: int = DEFAULT_MAX_OFFSET,
) -> np.ndarray:
    """Binary boundary labels for each clip on the grid.

    A clip is positive iff its IoU with any cut-point window reaches
    ``(N - max_offset) / (N + max_offset)``.


    Copied from video_chapter_generation_tpu/data/clip_grid.py:82.
    """
    half = int(clip_frame_num // 2)
    thresh = (clip_frame_num - max_offset) / (clip_frame_num + max_offset)
    labels = np.zeros(len(clips), dtype=np.int32)
    for idx, (start_t, end_t) in enumerate(clips):
        for cp in cut_points:
            if clip_iou_with_cut_point(start_t, end_t, cp, half) >= thresh:
                labels[idx] = 1
                break
    return labels


def frame_indices_for_clip(
    clip_start: int, clip_end: int, image_num: int, clip_frame_num: int
) -> List[int]:
    """1-based frame file indices ("%05d.jpg" % i) for a clip.

    The reference compensates a systematic ffmpeg extraction misalignment by
    offsetting interior clips +3 frames while clips near either end of the
    video stay at +1 (youtube_dataset.py:179-192). Reproduced exactly.


    Copied from video_chapter_generation_tpu/data/clip_grid.py:104.
    """
    near_edge = clip_start <= 2 or clip_start >= image_num - clip_frame_num - 2
    offset = 1 if near_edge else 3
    return [idx + offset for idx in range(clip_start, clip_end)]


def subtitle_text_for_window(
    subtitles: Sequence[Dict],
    start_sec: float,
    end_sec: float,
    time_gap: float = TEXT_EXTRA_TIME_GAP,
    fps: int = 1,
    early_stop: bool = False,
) -> str:
    """Concatenate subtitle texts whose start falls strictly inside
    (start_sec - gap, end_sec + gap). ``early_stop`` mirrors the chapter-title
    dataset which breaks once past the window (sorted subtitles assumed).

    Copied from video_chapter_generation_tpu/data/clip_grid.py:118.
    """
    parts: List[str] = []
    for sub in subtitles:
        t = sub["start"] * fps
        if start_sec - time_gap < t < end_sec + time_gap:
            parts.append(sub["text"])
        elif early_stop and t >= end_sec + time_gap:
            break
    return " ".join(parts)


@dataclass
class ClipInfo:
    """One clip of one video — the unit of boundary classification.

    Mirrors the dict schema of flat_video2clip_for_quick_infer.py:112-119 so
    flattened-clip JSON files are interchangeable with the reference's.


    Copied from video_chapter_generation_tpu/data/clip_grid.py:140.
    """

    image_paths: List[str]
    text_clip: str
    clip_label: int
    clip_start_end: Tuple[int, int]
    cut_points: List[int]
    vid: str
    pred_score: Optional[float] = None
    pred_label: Optional[int] = None

    def to_json(self) -> Dict:
        d = {
            "image_paths": self.image_paths,
            "text_clip": self.text_clip,
            "clip_label": int(self.clip_label),
            "clip_start_end": list(self.clip_start_end),
            "cut_points": list(self.cut_points),
            "vid": self.vid,
        }
        if self.pred_score is not None:
            d["pred_score"] = float(self.pred_score)
        if self.pred_label is not None:
            d["pred_label"] = int(self.pred_label)
        return d

    @classmethod
    def from_json(cls, d: Dict) -> "ClipInfo":
        return cls(
            image_paths=list(d["image_paths"]),
            text_clip=d["text_clip"],
            clip_label=int(d["clip_label"]),
            clip_start_end=tuple(d["clip_start_end"]),
            cut_points=list(d["cut_points"]),
            vid=d["vid"],
            pred_score=d.get("pred_score"),
            pred_label=d.get("pred_label"),
        )


def flatten_video_to_clips(
    vid: str,
    image_dir: str,
    image_num: int,
    raw_cut_secs: Sequence[int],
    subtitles: Sequence[Dict],
    clip_frame_num: int,
    fps: int = 1,
    max_offset: Optional[int] = None,
) -> List[ClipInfo]:
    """Precompute every clip of a video for fast batched inference.

    TPU-native analogue of flat_video2clip_for_quick_infer.py:12-125: identical
    grid, labels, subtitle windows and frame paths, but emitted as ClipInfo
    records ready for bucketed device batching.


    Copied from video_chapter_generation_tpu/data/clip_grid.py:185.
    """
    import os

    if max_offset is None:
        max_offset = DEFAULT_MAX_OFFSET * fps
    cut_points = valid_cut_points(raw_cut_secs, image_num, fps=fps, mode="infer")
    clips = build_clip_grid(image_num, clip_frame_num, max_offset)
    labels = label_clips(clips, cut_points, clip_frame_num, max_offset)

    infos: List[ClipInfo] = []
    for (start_t, end_t), label in zip(clips, labels):
        text_clip = subtitle_text_for_window(
            subtitles, start_t, end_t, TEXT_EXTRA_TIME_GAP * fps, fps=fps
        )
        frame_ids = frame_indices_for_clip(start_t, end_t, image_num, clip_frame_num)
        img_paths = [
            os.path.join(image_dir, vid, "%05d.jpg" % i) for i in frame_ids
        ]
        infos.append(
            ClipInfo(
                image_paths=img_paths,
                text_clip=text_clip,
                clip_label=int(label),
                clip_start_end=(start_t, end_t),
                cut_points=list(cut_points),
                vid=vid,
            )
        )
    return infos


def chapter_spans(
    timepoint_secs: Sequence[int], duration: float
) -> List[Tuple[int, float]]:
    """Chapter (start, end) spans: each chapter ends at the next chapter's
    start, the last at video duration (youtube_chapter_title_dataset.py:74-81).


    Copied from video_chapter_generation_tpu/data/clip_grid.py:231.
    """
    spans = []
    for i, start in enumerate(timepoint_secs):
        end = timepoint_secs[i + 1] if i + 1 < len(timepoint_secs) else duration
        spans.append((start, end))
    return spans
