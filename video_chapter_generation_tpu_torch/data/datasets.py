"""Dataset classes: torch-free, deterministic, numpy-batch producing.

The port's own copy of video_chapter_generation_tpu/data/datasets.py (the definitions the port uses;
each names the line it was copied from), so the port never imports
the JAX package.
"""

from __future__ import annotations
import json
from dataclasses import dataclass
from typing import Dict, Sequence
import numpy as np
from ..core.seeding import host_rng
from .clip_grid import (
    ClipInfo,
    build_clip_grid,
    frame_indices_for_clip,
    label_clips,
    subtitle_text_for_window,
    valid_cut_points,
)
from .corpus import VideoCorpus
from .frames import FRAME_HW, FrameCache, load_clip_frames
from .text_encode import encode_clip_text


def _video_clip_structure(corpus: VideoCorpus, vid: str, clip_frame_num: int,
                          fps: int = 1, cut_mode: str = "infer"):
    """Copied from video_chapter_generation_tpu/data/datasets.py:57."""
    image_num = corpus.image_num(vid)
    cut_points = valid_cut_points(
        corpus.raw_cut_secs(vid), image_num, fps=fps, mode=cut_mode
    )
    max_offset = 2 * fps
    clips = build_clip_grid(image_num, clip_frame_num, max_offset)
    labels = label_clips(clips, cut_points, clip_frame_num, max_offset)
    return image_num, cut_points, clips, labels


def _clip_images(corpus, vid, clip, image_num, clip_frame_num, hw, cache):
    """Copied from video_chapter_generation_tpu/data/datasets.py:69."""
    start, end = clip
    idx = frame_indices_for_clip(start, end, image_num, clip_frame_num)
    paths = [corpus.frame_path(vid, i) for i in idx]
    return load_clip_frames(paths, hw, cache)


class ClipDataset:
    """Training sampler: one positive-or-negative clip per video per epoch.

    Copied from video_chapter_generation_tpu/data/datasets.py:76.
    """

    def __init__(self, corpus: VideoCorpus, tokenizer, clip_frame_num: int = 16,
                 max_text_len: int = 100, mode: str = "all", fps: int = 1,
                 seed: int = 123, hw: int = FRAME_HW, s2d: bool = False):
        self.corpus = corpus
        self.tokenizer = tokenizer
        self.clip_frame_num = clip_frame_num
        self.max_text_len = max_text_len
        self.mode = mode
        self.fps = fps
        self.seed = seed
        self.hw = hw
        self.s2d = s2d  # emit uint8 4x4 space-to-depth (stem_input="s2d")
        self.cache = FrameCache()

    def __len__(self):
        return len(self.corpus.vids)

    def __getitem__(self, i: int, epoch: int = 0) -> Dict[str, np.ndarray]:
        rng = host_rng(self.seed, epoch, i)
        vid = self.corpus.vids[i]
        # NOTE: the train variant keeps cut points up to image_num
        # (youtube_dataset.py:82-87)
        image_num, cut_points, clips, labels = _video_clip_structure(
            self.corpus, vid, self.clip_frame_num, self.fps, cut_mode="train"
        )
        pos = np.flatnonzero(labels == 1)
        neg = np.flatnonzero(labels == 0)
        is_positive = int(rng.integers(0, 2)) if len(pos) else 0
        pool = pos if is_positive else neg
        target = int(pool[rng.integers(0, len(pool))])
        clip = clips[target]

        text = subtitle_text_for_window(
            self.corpus.subtitles(vid), clip[0], clip[1], 1 * self.fps,
            fps=self.fps,
        )
        ids, mask = encode_clip_text(text, self.tokenizer, self.max_text_len)
        out = {
            "text_ids": ids,
            "attention_mask": mask,
            "label": np.int32(is_positive),
        }
        if self.mode != "text":
            imgs = _clip_images(
                self.corpus, vid, clip, image_num, self.clip_frame_num,
                self.hw, self.cache,
            )
            if self.s2d:
                from .frames import space_to_depth4

                imgs = space_to_depth4(imgs)
            out["img_clip"] = imgs
        return out


class InferClipDataset:
    """Sequential eval over precomputed flattened clips (the workhorse).

    Copied from video_chapter_generation_tpu/data/datasets.py:221.
    """

    def __init__(self, clips: Sequence[ClipInfo], tokenizer,
                 max_text_len: int = 100, mode: str = "all",
                 hw: int = FRAME_HW):
        self.all_clip_infos = list(clips)
        self.tokenizer = tokenizer
        self.max_text_len = max_text_len
        self.mode = mode
        self.hw = hw
        self.cache = FrameCache()

    @classmethod
    def from_json(cls, path: str, tokenizer, **kw) -> "InferClipDataset":
        with open(path) as f:
            data = json.load(f)
        return cls([ClipInfo.from_json(d) for d in data], tokenizer, **kw)

    def __len__(self):
        return len(self.all_clip_infos)

    def __getitem__(self, i: int, epoch: int = 0) -> Dict[str, np.ndarray]:
        info = self.all_clip_infos[i]
        ids, mask = encode_clip_text(
            info.text_clip, self.tokenizer, self.max_text_len
        )
        out = {
            "text_ids": ids,
            "attention_mask": mask,
            "label": np.int32(info.clip_label),
            "clip_index": np.int32(i),
        }
        if self.mode != "text":
            out["img_clip"] = load_clip_frames(
                info.image_paths, self.hw, self.cache
            )
        return out


def _chapter_text(subtitles, start_t, end_t, fps: int = 1) -> str:
    """Copied from video_chapter_generation_tpu/data/datasets.py:338."""
    text = subtitle_text_for_window(
        subtitles, start_t, end_t, 1 * fps, fps=fps, early_stop=True
    )
    return " ".join(text.split()).lower()
