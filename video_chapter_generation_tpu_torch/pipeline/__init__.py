"""Per-video orchestration: boundary scoring and title generation, on
one device or sharded over the devices of a process, and video-level
fan-out over processes."""

from .boundary import (
    make_packed_two_stream_score_fn,
    make_text_score_fn,
    make_two_stream_score_fn,
    make_window_score_fn,
    pack_to_device,
    score_clips,
)
from .sharded import (
    make_sharded_text_score_fn,
    make_sharded_two_stream_score_fn,
    make_sharded_window_score_fn,
    run_videos_distributed,
    shard_title_fn,
)
from .vision_emb import extract_vision_embs, make_vision_embed_fn
from .whole_video import ChapterPipeline, VideoChapters, bucket_title_fn

__all__ = [
    "make_packed_two_stream_score_fn",
    "make_text_score_fn",
    "make_two_stream_score_fn",
    "make_window_score_fn",
    "make_sharded_text_score_fn",
    "make_sharded_two_stream_score_fn",
    "make_sharded_window_score_fn",
    "run_videos_distributed",
    "shard_title_fn",
    "pack_to_device",
    "score_clips",
    "ChapterPipeline",
    "VideoChapters",
    "bucket_title_fn",
    "extract_vision_embs",
    "make_vision_embed_fn",
]
