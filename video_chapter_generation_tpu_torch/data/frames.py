"""Host-side frame IO: JPEG decode, resize, caching, memmap packs.

The port's own copy of video_chapter_generation_tpu/data/frames.py (the definitions the port uses;
each names the line it was copied from), so the port never imports
the JAX package. When the native decoder (data/native_loader.py) is
installed, `load_clip_frames` decodes through it.
"""

from __future__ import annotations
import os
from collections import OrderedDict
from typing import Dict, Optional, Sequence
import numpy as np
from ..core.metrics import span


FRAME_HW = 224


_native_loader = None


def set_native_loader(loader) -> None:
    """Install a native decode function: paths list -> uint8 [N,H,W,3]
    (data/native_loader.py:install_native_loader installs one; None puts
    PIL back).

    Copied from video_chapter_generation_tpu/data/frames.py:29.
    """
    global _native_loader
    _native_loader = loader


def load_frame(path: str, hw: int = FRAME_HW) -> np.ndarray:
    """Decode one JPEG to uint8 [hw, hw, 3]; missing file -> zeros (the
    reference crashes on gaps; zero-fill keeps batch shapes static).

    Copied from video_chapter_generation_tpu/data/frames.py:35.
    """
    if not os.path.exists(path):
        return np.zeros((hw, hw, 3), np.uint8)
    from PIL import Image

    with Image.open(path) as img:
        img = img.convert("RGB")
        if img.size != (hw, hw):
            img = img.resize((hw, hw))
        return np.asarray(img, dtype=np.uint8)


def load_clip_frames(paths: Sequence[str], hw: int = FRAME_HW,
                     cache: Optional["FrameCache"] = None,
                     s2d: bool = False) -> np.ndarray:
    """Decode a clip's frames -> uint8 [T, hw, hw, 3]; with s2d=True, the
    4x4 space-to-depth view [T, hw/4, hw/4, 48] the fused TPU stem
    consumes (emitted directly by the native decoder when built).

    Copied from video_chapter_generation_tpu/data/frames.py:49.
    """
    if s2d:
        if (_native_loader is not None and cache is None
                and hasattr(_native_loader, "s2d")):
            return _native_loader.s2d(list(paths), hw)
        return space_to_depth4(load_clip_frames(paths, hw, cache))
    if _native_loader is not None and cache is None:
        return _native_loader(list(paths), hw)
    out = np.empty((len(paths), hw, hw, 3), np.uint8)
    for i, p in enumerate(paths):
        out[i] = cache.get(p, hw) if cache is not None else load_frame(p, hw)
    return out


class FrameCache:
    """Bounded LRU uint8 frame cache (infer_youtube_video_dataset.py:851-865).
    Each miss is decoded under a "decode" span on the thread's current
    timer (core/metrics.py), whose items equal `misses`.

    Copied from video_chapter_generation_tpu/data/frames.py:70.
    """

    def __init__(self, max_frames: int = 4096):
        self.max_frames = max_frames
        self._cache: OrderedDict[str, np.ndarray] = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, path: str, hw: int = FRAME_HW) -> np.ndarray:
        if path in self._cache:
            self._cache.move_to_end(path)
            self.hits += 1
            return self._cache[path]
        self.misses += 1
        with span("decode"):
            frame = load_frame(path, hw)
        self._cache[path] = frame
        if len(self._cache) > self.max_frames:
            self._cache.popitem(last=False)
        return frame

    def clear(self) -> None:
        self._cache.clear()


class VideoFramePack:
    """Per-video uint8 memmap pack: decode each frame once, then serve any
    clip as a zero-copy slice (WindowClipDatasetv2's memmap cache,
    youtube_dataset.py:638-664).

    Copied from video_chapter_generation_tpu/data/frames.py:95.
    """

    def __init__(self, cache_dir: str, vid: str, frame_paths: Sequence[str],
                 hw: int = FRAME_HW):
        os.makedirs(cache_dir, exist_ok=True)
        self.hw = hw
        self.n = len(frame_paths)
        self.path = os.path.join(cache_dir, f"{vid}_{hw}.u8")
        if not os.path.exists(self.path) or (
            os.path.getsize(self.path) != self.n * hw * hw * 3
        ):
            mm = np.memmap(self.path, np.uint8, "w+", shape=(self.n, hw, hw, 3))
            for i, p in enumerate(frame_paths):
                mm[i] = load_frame(p, hw)
            mm.flush()
        self.mm = np.memmap(self.path, np.uint8, "r", shape=(self.n, hw, hw, 3))

    def clip(self, frame_indices_1based: Sequence[int]) -> np.ndarray:
        """Serve frames by the 1-based file indices used everywhere else."""
        idx = np.asarray(frame_indices_1based) - 1
        idx = np.clip(idx, 0, self.n - 1)
        return np.asarray(self.mm[idx])


def space_to_depth4(frames: np.ndarray) -> np.ndarray:
    """uint8 [..., H, W, 3] -> [..., H/4, W/4, 48] (numpy fallback for the
    native s2d decode path; channel order di*12 + dj*3 + c).

    Copied from video_chapter_generation_tpu/data/native_loader.py:123.
    """
    *lead, h, w, c = frames.shape
    out = frames.reshape(*lead, h // 4, 4, w // 4, 4, c)
    nd = out.ndim
    out = out.transpose(*range(nd - 5), nd - 5, nd - 3, nd - 4, nd - 2,
                        nd - 1)
    return np.ascontiguousarray(out).reshape(*lead, h // 4, w // 4, 48)
