"""Dump per-clip vision embeddings for vision-conditioned titles
(counterpart of the JAX package's cli/extract_vision_emb.py; the
reference's convert2vision_emb.py).

    python -m video_chapter_generation_tpu_torch.cli.extract_vision_emb \
        data.test_clips_json=clips.json [--out_dir vision_embs] [--int8] \
        [--tiny] [--device cpu]

Runs on the card unless --device says otherwise. Reads the clips JSON
(ClipInfo.to_json rows), runs the ResNet50-TSM embedder over
data.batch_size clips a call and writes <out_dir>/<vid>/
vision_emb_<start>_<end>.npy, float32 [T, 2048], one per clip, for
cli/infer_video --vision_emb_dir. The trunk has seeded random weights
(seed 0; the JAX CLI initializes its flax model from PRNGKey(0)). On the
card, without --tiny, the frames go in as the uint8 s2d pack and the
trunk runs in bf16 (the stem kernel K1, then K2/K3 and K4); --tiny (64
px, one block a stage) and the CPU take frames and float32. --int8
calibrates the W8A8 trunk (K9) on the first batch of clips and serves it;
the stem stays bf16.
"""

from __future__ import annotations

import json
import sys
from typing import Optional

import torch

from ..core.metrics import StepTimer
from ..data.clip_grid import ClipInfo
from ..data.frames import load_clip_frames
from ..device import resolve_device
from ..models import convert
from ..models.resnet import STAGE_SIZES, Resnet50TSM
from ..ops.quantize import calibrate_tsm_quant
from ..pipeline.vision_emb import extract_vision_embs, make_vision_embed_fn
from ..train.tasks import TINY_STAGE_SIZES
from .common import parse_config, pop_flag


def init_weights(model: Resnet50TSM) -> dict:
    """The trunk's seeded random weights in the JAX layout, carried over
    (models/convert.py) as a float32 state dict of model.base_model."""
    sizes = model.base_model.stage_sizes
    tree = convert.random_jax_tree(model.base_model,
                                   convert.resnet_entries(sizes), seed=0)
    return convert.from_jax_resnet(tree, sizes)


def main(argv=None, timer: Optional[StepTimer] = None) -> int:
    """Returns the number of clip embeddings written; `timer` (a
    StepTimer) receives the host_load and embed stages."""
    argv = list(argv if argv is not None else sys.argv[1:])
    out_dir = pop_flag(argv, "--out_dir") or "vision_embs"
    int8 = pop_flag(argv, "--int8", value=False) is not None

    cfg, args = parse_config(argv, "extract vision embeddings")
    dev = resolve_device(args.device)
    with open(cfg.data.test_clips_json) as f:
        clips = [ClipInfo.from_json(d) for d in json.load(f)]

    tiny = args.tiny
    s2d = dev.type == "cuda" and not tiny  # JAX: backend == "tpu"
    hw = 64 if tiny else 224
    model = Resnet50TSM(
        cfg.data.clip_frame_num, stem_input="s2d" if s2d else "frames",
        stage_sizes=TINY_STAGE_SIZES if tiny else STAGE_SIZES[50],
        dtype=torch.float32 if tiny else torch.bfloat16)
    model.base_model.load_state_dict(init_weights(model))
    model.to(dev).eval()
    if int8:
        ncal = min(len(clips), cfg.data.batch_size)
        cal = torch.stack([
            torch.from_numpy(load_clip_frames(clips[i].image_paths, hw,
                                              s2d=s2d))
            for i in range(ncal)]).to(dev)
        model = model.quantized(calibrate_tsm_quant(model, cal))
    embed_fn = make_vision_embed_fn(model, dev)

    count = 0
    for _ in extract_vision_embs(clips, embed_fn, cfg.data.batch_size, hw,
                                 out_dir, timer=timer, s2d=s2d):
        count += 1
    print(f"wrote {count} clip embeddings to {out_dir}")
    return count


if __name__ == "__main__":
    main()
