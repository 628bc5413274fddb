"""Whole-pipeline per-video inference on the port: boundaries -> cut
points -> titles (counterpart of the JAX package's cli/infer_video.py).

    python -m video_chapter_generation_tpu_torch.cli.infer_video \
        model.kind=two_stream data.img_dir=... data.data_file=... \
        data.subtitle_dir=... data.test_vid_file=... train.ckpt_dir=... \
        [--vids vid1,vid2] [--bert_vocab v.txt] [--spm_tsv spm.tsv] \
        [--title_arch pegasus|bigbird|bart] [--num_beams N] \
        [--vision_emb_dir DIR [--fusion_type cross_attn|mlp]] \
        [--int8_vision] [--int8_titles] [--pipelined] [--sharded] \
        [--tiny] [--device cpu]
    torchrun --nproc_per_node N -m \
        video_chapter_generation_tpu_torch.cli.infer_video <the same>

Runs on the card unless --device says otherwise. The boundary model
(model.kind two_stream, or text: the subtitle-only BertForChapter) is the
best checkpoint of its kind in train.ckpt_dir (else the newest; its
contract must match this config), scoring per-clip frames (uint8 ->
normalized on the device -> the frames stem, model.stem_input=frames).
The title model
(--title_arch: Pegasus-large, BigBird-Pegasus-large or BART-large)
decodes data.title_decode_len tokens, greedy or, with --num_beams N > 1,
by beam search, from the best title checkpoint in the same directory
(cli/train_title's), else seeded random weights (a line says which). --vision_emb_dir DIR (the
output of cli/extract_vision_emb) conditions the titles on each
chapter's vision embeddings: the title model becomes Seq2SeqVisionEmb
with the --fusion_type head (cross_attn, the default, or mlp), its fused
encoder states feed the decoder (the JAX package's best-ROUGE
configuration: --vision_emb_dir vision_embs --num_beams 4). BigBird
wants long title inputs: give it data.title_input_len=3072 (its encoder
then runs the block-sparse kernel K10 in every layer; at the default 512
it falls back to full attention). --int8_vision serves the W8A8 vision
trunk, its activation scales calibrated on the first video's frames;
--int8_titles serves the title model in weight-only int8 with an int8
cross-attention cache (the fusion head stays float). Writes
test_results/whole_pipeline_result.txt and prints one JSON line per
video.

--sharded shards clip scoring and title decode over the process's cards
(parallel/mesh.py:local_devices; on the CPU, two CPU shards): one
replica of each model a card, data.batch_size divisible by the card
count (pipeline/sharded.py). Under a launcher (torchrun sets RANK,
WORLD_SIZE, MASTER_ADDR, MASTER_PORT) the processes join a group
(parallel/dist.py: NCCL where each process of the host has a card of
its own, gloo where they share one), local process r serves on card r
(modulo the card count), each process chapters vids[rank::world] and
the merged results reach every process; only the first writes the
result file and the JSON lines (the JAX CLI has every process write the
same file), each prints the videos it served.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict

import numpy as np

from ..core.contract import vocab_hash
from ..data.datasets import npy_vision_emb_provider
from ..data.frames import load_clip_frames
from ..device import resolve_device
from ..models.seq2seq import FUSION_TYPES
from ..parallel import dist
from ..parallel.mesh import local_devices, make_mesh
from ..pipeline import (
    ChapterPipeline,
    VideoChapters,
    run_videos_distributed,
    shard_title_fn,
)
from ..train.tasks import TitleGenTask, TitleGenVisionTask
from .common import (
    load_bert_tokenizer,
    load_corpus,
    load_title_tokenizer,
    parse_config,
    pop_flag,
    title_s2s_config,
)
from .eval_segment import build_score_fn
from .eval_title import VISION_EMB_DIM, build_title_model

KIND_NOT_PORTED = {
    # the JAX CLI cannot serve it either: its ChapterPipeline builds
    # per-clip batches ("img_clip", pipeline/whole_video.py:82,177) and
    # make_window_score_fn reads "img_clips" (pipeline/boundary.py:218)
    "two_stream_window": "the JAX package's infer_video cannot serve the "
                         "window model either (its per-clip batches carry "
                         "no window: a KeyError); ROADMAP lists this under "
                         "the JAX package's faults. Train and score the "
                         "window model with cli/train_segment and "
                         "cli/eval_segment.build_score_fn",
}


def calibration_clips(cfg, corpus, vid: str, hw: int) -> np.ndarray:
    """Up to data.batch_size clips of `vid`'s frames, uint8 [B, T, hw, hw,
    3], the frames the JAX CLI calibrates on (infer_video.py:113-126)."""
    seg = cfg.data.clip_frame_num
    n_img = corpus.image_num(vid)
    starts = list(range(0, max(1, n_img - seg), seg))[:cfg.data.batch_size]
    return np.stack([
        load_clip_frames([corpus.frame_path(vid, min(s + k + 1, n_img))
                          for k in range(seg)], hw)
        for s in starts])


def main(argv=None) -> Dict[str, VideoChapters]:
    argv = list(argv if argv is not None else sys.argv[1:])
    vids = pop_flag(argv, "--vids")
    vids = vids.split(",") if vids else None
    sharded = pop_flag(argv, "--sharded", value=False) is not None
    vision_emb_dir = pop_flag(argv, "--vision_emb_dir")
    fusion_type = pop_flag(argv, "--fusion_type") or "cross_attn"
    if fusion_type not in FUSION_TYPES:
        raise SystemExit(f"--fusion_type {fusion_type}: one of "
                         f"{', '.join(FUSION_TYPES)}")
    num_beams = int(pop_flag(argv, "--num_beams") or 1)
    pipelined = pop_flag(argv, "--pipelined", value=False) is not None
    int8_titles = pop_flag(argv, "--int8_titles", value=False) is not None
    int8_vision = pop_flag(argv, "--int8_vision", value=False) is not None

    cfg, args = parse_config(argv, "whole-pipeline per-video inference")
    kind = cfg.model.kind
    if kind in KIND_NOT_PORTED:
        raise SystemExit(f"model.kind={kind} is not ported to the PyTorch "
                         f"port yet: {KIND_NOT_PORTED[kind]}")
    if kind not in ("two_stream", "text"):
        raise SystemExit(f"unknown model.kind {kind}")
    if int8_vision and kind != "two_stream":
        raise SystemExit("--int8_vision needs model.kind=two_stream (the "
                         "JAX CLI's rule, infer_video.py:99-101)")
    if int8_vision and cfg.model.stem_input != "frames":
        raise SystemExit("--int8_vision on this CLI serves "
                         "model.stem_input=frames only (the JAX CLI's rule, "
                         "infer_video.py:108); s2d stems take the packed "
                         "pipeline")
    owned = dist.initialize()  # a launcher's environment, else nothing
    try:
        return _serve(cfg, args, vids, sharded, vision_emb_dir, fusion_type,
                      num_beams, pipelined, int8_titles, int8_vision)
    finally:
        if owned:
            dist.shutdown()


def _serve(cfg, args, vids, sharded, vision_emb_dir, fusion_type, num_beams,
           pipelined, int8_titles, int8_vision) -> Dict[str, VideoChapters]:
    devices = local_devices(resolve_device(args.device))
    dev, mesh = devices[0], None
    if sharded:
        mesh = make_mesh(devices=devices)
        if cfg.data.batch_size % mesh.shape["data"]:
            raise SystemExit(f"--sharded: data.batch_size "
                             f"{cfg.data.batch_size} is not divisible by the "
                             f"mesh's data axis {mesh.shape}")
    corpus = load_corpus(cfg, "test")
    tokenizer = load_bert_tokenizer(args, corpus)
    title_tokenizer = load_title_tokenizer(args, corpus)
    s2s_cfg = title_s2s_config(args, title_tokenizer)
    hw = 64 if args.tiny else 224  # train_segment's frame contract

    calib = (calibration_clips(cfg, corpus, (vids or corpus.vids)[0], hw)
             if int8_vision else None)
    score_fn = build_score_fn(cfg, args, tokenizer, calib_clips=calib,
                              device=dev, mesh=mesh)

    vision = vision_emb_dir is not None
    task = (TitleGenVisionTask(cfg, s2s_cfg, fusion_type, VISION_EMB_DIM)
            if vision else TitleGenTask(cfg, s2s_cfg))
    task.contract = dict(task.contract, vocab_hash=vocab_hash(title_tokenizer))
    _, title_fn = build_title_model(cfg, task, dev, num_beams, int8_titles)
    if mesh is not None:
        title_fn = shard_title_fn(title_fn, mesh)

    pipe = ChapterPipeline(
        corpus, tokenizer, score_fn, title_fn,
        decode_fn=title_tokenizer.decode,
        clip_frame_num=cfg.data.clip_frame_num,
        max_text_len=cfg.data.max_text_len,
        title_input_len=cfg.data.title_input_len,
        batch_size=cfg.data.batch_size, score_mode=cfg.model.data_mode,
        hw=hw, title_tokenizer=title_tokenizer, device=dev,
        vision_emb_provider=(npy_vision_emb_provider(vision_emb_dir)
                             if vision else None),
        vision_emb_dim=VISION_EMB_DIM)
    if dist.process_count() > 1:
        rank, world = dist.process_index(), dist.process_count()
        print(f"process {rank} of {world} (backend {dist.backend()}, "
              f"{dev}{', mesh ' + str(mesh.shape) if mesh else ''}) serves "
              f"{json.dumps(list(vids or corpus.vids)[rank::world])}",
              flush=True)
        results = run_videos_distributed(pipe, vids, pipelined=pipelined)
    else:
        results = pipe.run(vids, pipelined=pipelined)

    if dist.is_primary():
        os.makedirs("test_results", exist_ok=True)
        out_path = "test_results/whole_pipeline_result.txt"
        with open(out_path, "w") as f:
            for vid, r in results.items():
                print(json.dumps({"vid": vid, "cut_points": r.cut_points,
                                  "titles": r.titles}))
                f.write(f"vid: {vid}\n")
                f.write(f"pred cut points: {r.cut_points}\n")
                f.write(f"gt cut points: {corpus.raw_cut_secs(vid)}\n")
                for (start, end), title in zip(r.spans, r.titles):
                    f.write(f"  [{start} - {end}] {title}\n")
                f.write("\n")
        print(f"wrote {out_path}")
    print(f"throughput: {pipe.videos_per_minute():.2f} videos/min")
    print(f"stage seconds: {json.dumps(pipe.timer.summary())}")
    return results


if __name__ == "__main__":
    main()
