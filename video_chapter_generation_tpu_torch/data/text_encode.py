"""Fixed-length text encodings matching the reference's manual pad schemes.

The port's own copy of video_chapter_generation_tpu/data/text_encode.py (the definitions the port uses;
each names the line it was copied from), so the port never imports
the JAX package.
"""

from __future__ import annotations
from typing import Dict, Tuple
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


def encode_title_decoder(
    title: str, tokenizer, chapter_title_text_len: int = 30
) -> Dict[str, np.ndarray]:
    """Manual shift-right decoder encoding of a chapter title.

    decoder start token = pad token (Pegasus convention); targets end with
    EOS (EOS overwrites the last position when the title is too long);
    both sides padded with EOS beyond the mask.

    Copied from video_chapter_generation_tpu/data/text_encode.py:56.
    """
    bos_token = tokenizer.pad_token
    eos_token = tokenizer.eos_token

    decode_tokens = tokenizer.tokenize(title)
    input_decode_tokens = ([bos_token] + decode_tokens)[:chapter_title_text_len]

    if len(decode_tokens) >= chapter_title_text_len:
        target_decode_tokens = list(decode_tokens)
        target_decode_tokens[chapter_title_text_len - 1] = eos_token
    else:
        target_decode_tokens = decode_tokens + [eos_token]
    target_decode_tokens = target_decode_tokens[:chapter_title_text_len]

    decode_attention_mask = [1] * (len(decode_tokens) + 1)
    decode_attention_mask = decode_attention_mask[:chapter_title_text_len]
    if len(decode_attention_mask) < chapter_title_text_len:
        n_pad = chapter_title_text_len - len(decode_attention_mask)
        input_decode_tokens = input_decode_tokens + [eos_token] * n_pad
        target_decode_tokens = target_decode_tokens + [eos_token] * n_pad
        decode_attention_mask = decode_attention_mask + [0] * n_pad

    return {
        "input_decode_ids": np.asarray(
            tokenizer.convert_tokens_to_ids(input_decode_tokens), dtype=np.int32
        ),
        "target_decode_ids": np.asarray(
            tokenizer.convert_tokens_to_ids(target_decode_tokens), dtype=np.int32
        ),
        "decode_attention_mask": np.asarray(decode_attention_mask, dtype=np.int32),
    }
