"""The host side of chaptering, as the reference repository defines it,
written again so that the reference judges the program's outputs from
the raw inputs (frames on disk, subtitles, the vocabularies) and never
from what the program prepared.

Clips: 16 frames at stride 4 seconds, starts range(0, n - 16, 4); the
frame files of a clip are 1-based, offset +1 near either end of the video
and +3 inside (youtube_dataset.py's extraction fix). A clip's text is the
subtitles starting strictly within one second of its span, with [CLS]
in front, cut or padded to 100 tokens. Cut points come from runs of
positive clips (eval_utils.py).
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

BERT_CLS, BERT_PAD, BERT_FIRST_WORD = 2, 0, 5


def clip_starts(n_frames: int, clip_frames: int = 16, stride: int = 4):
    return list(range(0, n_frames - clip_frames, stride))


def clip_frame_files(start: int, n_frames: int, clip_frames: int = 16
                     ) -> List[int]:
    edge = start <= 2 or start >= n_frames - clip_frames - 2
    off = 1 if edge else 3
    return [i + off for i in range(start, start + clip_frames)]


def window_text(subs: Sequence[dict], lo: float, hi: float,
                gap: float = 1.0) -> str:
    return " ".join(s["text"] for s in subs
                    if lo - gap < s["start"] < hi + gap)


def encode(ids: List[int], length: int, pad: int) -> Tuple[np.ndarray,
                                                            np.ndarray]:
    ids = ids[:length]
    mask = [1] * len(ids) + [0] * (length - len(ids))
    return (np.asarray(ids + [pad] * (length - len(ids)), np.int64),
            np.asarray(mask, np.int64))


def clip_text_ids(subs, start: int, word_id: Dict[str, int],
                  clip_frames: int = 16, length: int = 100):
    text = window_text(subs, start, start + clip_frames)
    ids = [BERT_CLS] + [BERT_FIRST_WORD + word_id[w] for w in text.split()]
    return encode(ids, length, BERT_PAD)


def cut_points(labels: Sequence[int], clip_frames: int = 16,
               stride: int = 4) -> List[int]:
    """A cut point at the rounded middle of each run of positive clips
    that ends before the last clip (Python's round, as eval_utils.py)."""
    out, inside, begin = [], False, 0
    for i, lab in enumerate(labels):
        if lab == 1 and not inside:
            inside, begin = True, i * stride
        if lab == 0 and inside:
            inside = False
            end = (i - 1) * stride + clip_frames
            out.append(round((begin + end - 1) / 2))
    return out


def load_frames(paths: Sequence[str], hw: int, threads: int = 8
                ) -> np.ndarray:
    """JPEG files -> uint8 [T, hw, hw, 3] by PIL (zeros for a missing
    file), decoded on `threads` threads."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    out = np.zeros((len(paths), hw, hw, 3), np.uint8)

    def one(i):
        if not os.path.exists(paths[i]):
            return
        with Image.open(paths[i]) as img:
            img = img.convert("RGB")
            if img.size != (hw, hw):
                img = img.resize((hw, hw))
            out[i] = np.asarray(img, dtype=np.uint8)

    with ThreadPoolExecutor(threads) as ex:
        list(ex.map(one, range(len(paths))))
    return out
