"""GloVe embedding loaders for the from-scratch GPT's pretrained-embedding
input mode, and its word vocabulary.

The port's own copy of video_chapter_generation_tpu/datasetkit/glove.py
(every definition; each names the line it was copied from), so the port
never imports the JAX package.
"""

from __future__ import annotations

import pickle
from typing import Dict

import numpy as np


def load_glove_txt(path: str) -> Dict[str, np.ndarray]:
    """Copied from video_chapter_generation_tpu/datasetkit/glove.py:12."""
    out: Dict[str, np.ndarray] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split(" ")
            try:
                vec = np.asarray([float(x) for x in parts[1:]], np.float32)
            except ValueError:
                continue
            if len(vec):
                out[parts[0]] = vec
    return out


def load_glove_pickle(path: str) -> Dict[str, np.ndarray]:
    """Copied from video_chapter_generation_tpu/datasetkit/glove.py:26."""
    with open(path, "rb") as f:
        return pickle.load(f)


def save_glove_pickle(emb: Dict[str, np.ndarray], path: str) -> None:
    """Copied from video_chapter_generation_tpu/datasetkit/glove.py:31."""
    with open(path, "wb") as f:
        pickle.dump(emb, f, protocol=pickle.HIGHEST_PROTOCOL)


def embed_tokens(tokens, table: Dict[str, np.ndarray],
                 dim: int = 300) -> np.ndarray:
    """Token list -> [L, dim]; OOV tokens get zeros.

    Copied from video_chapter_generation_tpu/datasetkit/glove.py:36.
    """
    out = np.zeros((len(tokens), dim), np.float32)
    for i, t in enumerate(tokens):
        v = table.get(t)
        if v is not None:
            out[i] = v[:dim]
    return out


def build_word_vocab(corpus) -> list:
    """Word-level vocab from a corpus's subtitles (lowercase, decontracted,
    whitespace-split, sorted) — the no-GloVe fallback for the from-scratch
    GPT.

    Copied from video_chapter_generation_tpu/datasetkit/glove.py:47.
    """
    from .parsing import text_decontracted

    words = set()
    for vid in corpus.vids:
        for sub in corpus.subtitles(vid):
            text = text_decontracted(str(sub.get("text", "")).lower())
            words.update(w for w in text.split(" ") if w)
    return sorted(words)
