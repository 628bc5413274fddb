"""Flatten test videos into a clips JSON for batched inference
(cli/eval_segment and cli/extract_vision_emb read it).

    python -m video_chapter_generation_tpu_torch.datasetkit.flatten \
        --img_dir frames/ --data_file all_in_one.csv \
        --vid_file test.txt --out test_clips.json --clip_frame_num 16

The port's own copy of video_chapter_generation_tpu/datasetkit/flatten.py (the definitions the port uses;
each names the line it was copied from), so the port never imports
the JAX package.
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional

from ..data.clip_grid import flatten_video_to_clips
from ..data.corpus import VideoCorpus


def flatten_corpus(corpus: VideoCorpus, clip_frame_num: int,
                   fps: int = 1) -> List[dict]:
    """Copied from video_chapter_generation_tpu/datasetkit/flatten.py:22."""
    out = []
    for vid in corpus.vids:
        clips = flatten_video_to_clips(
            vid, corpus.img_dir, corpus.image_num(vid),
            corpus.raw_cut_secs(vid), corpus.subtitles(vid),
            clip_frame_num, fps=fps,
        )
        out.extend(c.to_json() for c in clips)
    return out


def main(argv: Optional[List[str]] = None):
    """Copied from video_chapter_generation_tpu/datasetkit/flatten.py:35."""
    p = argparse.ArgumentParser()
    p.add_argument("--img_dir", required=True)
    p.add_argument("--data_file", required=True)
    p.add_argument("--vid_file", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--clip_frame_num", type=int, default=16)
    p.add_argument("--fps", type=int, default=1)
    p.add_argument("--subtitle_dir", default=None)
    args = p.parse_args(argv)

    corpus = VideoCorpus.from_files(
        args.img_dir, args.data_file, args.vid_file, args.subtitle_dir
    )
    clips = flatten_corpus(corpus, args.clip_frame_num, args.fps)
    with open(args.out, "w") as f:
        json.dump(clips, f)
    print(f"wrote {len(clips)} clips for {len(corpus)} videos to {args.out}")


if __name__ == "__main__":
    main()
