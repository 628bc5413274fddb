"""Fixed-length text encodings matching the reference's manual pad schemes.

The port's own copy of video_chapter_generation_tpu/data/text_encode.py (the definitions the port uses;
each names the line it was copied from), so the port never imports
the JAX package.
"""

from __future__ import annotations
from typing import Tuple
import numpy as np


def encode_clip_text(
    text: str, tokenizer, max_text_len: int = 100
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (text_ids[max_text_len], attention_mask[max_text_len]).

    Copied from video_chapter_generation_tpu/data/text_encode.py:20.
    """
    tokens = tokenizer.tokenize("[CLS] " + text)
    tokens = tokens[:max_text_len]
    attention_mask = [1] * len(tokens)
    if len(tokens) < max_text_len:
        n_pad = max_text_len - len(tokens)
        tokens = tokens + [tokenizer.pad_token] * n_pad
        attention_mask = attention_mask + [0] * n_pad
    ids = tokenizer.convert_tokens_to_ids(tokens)
    return (
        np.asarray(ids, dtype=np.int32),
        np.asarray(attention_mask, dtype=np.int32),
    )


def encode_encoder_text(
    text: str, tokenizer, max_text_len: int = 512
) -> Tuple[np.ndarray, np.ndarray]:
    """Seq2seq encoder input: tokenize, truncate, pad with pad_token.

    Copied from video_chapter_generation_tpu/data/text_encode.py:38.
    """
    tokens = tokenizer.tokenize(text)
    tokens = tokens[:max_text_len]
    attention_mask = [1] * len(tokens)
    if len(tokens) < max_text_len:
        n_pad = max_text_len - len(tokens)
        tokens = tokens + [tokenizer.pad_token] * n_pad
        attention_mask = attention_mask + [0] * n_pad
    ids = tokenizer.convert_tokens_to_ids(tokens)
    return (
        np.asarray(ids, dtype=np.int32),
        np.asarray(attention_mask, dtype=np.int32),
    )
