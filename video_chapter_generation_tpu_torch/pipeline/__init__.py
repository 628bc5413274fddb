"""Per-video orchestration: boundary scoring and title generation."""

from .boundary import (
    make_packed_two_stream_score_fn,
    make_text_score_fn,
    make_two_stream_score_fn,
    make_window_score_fn,
    pack_to_device,
    score_clips,
)
from .vision_emb import extract_vision_embs, make_vision_embed_fn
from .whole_video import ChapterPipeline, VideoChapters, bucket_title_fn

__all__ = [
    "make_packed_two_stream_score_fn",
    "make_text_score_fn",
    "make_two_stream_score_fn",
    "make_window_score_fn",
    "pack_to_device",
    "score_clips",
    "ChapterPipeline",
    "VideoChapters",
    "bucket_title_fn",
    "extract_vision_embs",
    "make_vision_embed_fn",
]
