"""Evaluate a boundary model on precomputed flattened clips (counterpart
of the JAX package's cli/eval_segment.py).

    python -m video_chapter_generation_tpu_torch.cli.eval_segment \
        data.test_clips_json=test_clips.json train.ckpt_dir=ckpt \
        [model.kind=two_stream_window|two_stream|text] [--bert_vocab v.txt] \
        [--compat_first_clip] [--int8_vision] [--tiny] [--device cpu]

Runs on the card unless --device says otherwise. Scores every clip of the
clips JSON (datasetkit/flatten.py writes it) with the best checkpoint of
the model kind in train.ckpt_dir (else the newest, else seeded random
weights), in data.batch_size batches; then per-video AUC/mAP, cut-point
recall/precision/F at 0, 3 and 5 s and the random baseline
(evalkit/segment_eval.py), written to
test_results/{kind}_head_{head_type}.txt and
..._vid2cut_points.json where it runs (cli/eval_title --location pred
reads the latter). --compat_first_clip counts each video's first clip
twice, as the reference's published result files do.
--int8_vision serves the W8A8 vision trunk of a frames-stem two-stream
model, its activation scales calibrated on the first batch of clips.
Without --bert_vocab a vocabulary is built from the clips' texts.
"""

from __future__ import annotations

import json
import sys
from typing import Dict, Optional

import numpy as np
import torch

from ..core.checkpoint import CheckpointManager
from ..core.contract import assert_contract, vocab_hash
from ..core.metrics import StepTimer
from ..data.datasets import InferClipDataset, InferWindowClipDataset
from ..data.tokenization import WordPieceTokenizer
from ..device import resolve_device
from ..evalkit.segment_eval import (
    evaluate_segment_predictions,
    write_segment_result_files,
)
from ..ops.quantize import calibrate_two_stream_quant
from ..parallel.mesh import Mesh
from ..pipeline.boundary import (
    make_text_score_fn,
    make_two_stream_score_fn,
    make_window_score_fn,
    score_clips,
)
from ..pipeline.sharded import (
    make_sharded_text_score_fn,
    make_sharded_two_stream_score_fn,
    make_sharded_window_score_fn,
)
from ..train.tasks import SegmentTask, SegmentTextTask, SegmentWindowTask
from .common import parse_config, pop_flag


def main(argv=None, timer: Optional[StepTimer] = None) -> Dict:
    """Returns the metric dict of evaluate_segment_predictions (with
    "vid2cut_points"); `timer` (a StepTimer) receives score_clips'
    host_load and device_score stages (JAX cli/eval_segment.py:27-93)."""
    argv = list(argv if argv is not None else sys.argv[1:])
    compat = pop_flag(argv, "--compat_first_clip", value=False) is not None
    int8_vision = pop_flag(argv, "--int8_vision", value=False) is not None
    cfg, args = parse_config(argv, "evaluate boundary model")
    kind = cfg.model.kind
    if kind not in ("text", "two_stream", "two_stream_window"):
        raise SystemExit(f"unknown model.kind {kind}")
    if int8_vision and kind == "text":
        raise SystemExit("--int8_vision needs a two-stream model.kind")
    if int8_vision and cfg.model.stem_input != "frames":
        raise SystemExit("--int8_vision on this CLI supports "
                         "model.stem_input=frames")
    dev = resolve_device(args.device)
    tokenizer = _tokenizer_from_clips(cfg, args)

    # the training frame contract (train_segment: 64 px with --tiny)
    hw = 64 if args.tiny else 224
    d = cfg.data
    if kind == "two_stream_window":
        ds = InferWindowClipDataset.from_json(
            d.test_clips_json, tokenizer, clip_frame_num=d.clip_frame_num,
            max_text_len=d.max_text_len, window_size=d.window_size,
            mode=cfg.model.data_mode, hw=hw)
    else:
        ds = InferClipDataset.from_json(
            d.test_clips_json, tokenizer, max_text_len=d.max_text_len,
            mode=cfg.model.data_mode, hw=hw)

    calib = None
    if int8_vision:  # the first batch of clips (JAX :54-67)
        n = min(d.batch_size, len(ds))
        if kind == "two_stream_window":  # [n, W, T, ...] -> [n*W, T, ...]
            calib = np.stack([ds[i]["img_clips"] for i in range(n)])
            calib = calib.reshape(-1, *calib.shape[2:])
        else:
            calib = np.stack([ds[i]["img_clip"] for i in range(n)])
    score_fn = build_score_fn(cfg, args, tokenizer, calib_clips=calib,
                              device=dev)
    score_clips(ds, score_fn, d.batch_size, timer=timer)

    result = evaluate_segment_predictions(
        ds.all_clip_infos, d.clip_frame_num, d.max_offset,
        rng=np.random.default_rng(cfg.train.seed),
        compat_first_clip_double_count=compat)
    out_prefix = f"test_results/{kind}_head_{cfg.model.head_type}"
    write_segment_result_files(result, f"{out_prefix}.txt",
                               f"{out_prefix}_vid2cut_points.json")
    for k in ("mAP", "recall_3", "precision_3", "f1_3"):
        print(k, result[k])
    return result


def _tokenizer_from_clips(cfg, args) -> WordPieceTokenizer:
    """The --bert_vocab file's tokenizer, else one built from the clips'
    texts (JAX cli/eval_segment.py:96-106)."""
    if args.bert_vocab:
        return WordPieceTokenizer.from_vocab_file(args.bert_vocab)
    with open(cfg.data.test_clips_json) as f:
        texts = [d["text_clip"] for d in json.load(f)]
    return WordPieceTokenizer.build_from_corpus(texts, vocab_size=8000)


def build_score_fn(cfg, args, tokenizer,
                   calib_clips: Optional[np.ndarray] = None, device=None,
                   mesh: Optional[Mesh] = None):
    """score(batch) -> positive-class probability [B] on the device, from
    the best checkpoint of the model kind in cfg.train.ckpt_dir (title
    checkpoints beside it are passed over), else the newest, else the
    task's seeded random weights. The checkpoint's contract must match
    this config's (core/contract.py), or ContractMismatch is raised.

    calib_clips (uint8 [B, T, H, W, 3] real frames; for the window model
    its window clips flattened to [B*W, T, ...]) turns on W8A8 serving of
    the vision trunk: its activation scales are calibrated on them
    (ops/quantize.py:calibrate_two_stream_quant) and the scorer runs the
    quantized twin. The window scorer takes InferWindowClipDataset
    batches ("img_clips"), the base and text ones InferClipDataset
    batches (text_ids and attention_mask only for text).

    With `mesh` (parallel/mesh.py) the scorer shards each batch over the
    mesh's data axis (pipeline/sharded.py; JAX :109-191): the model is
    restored and calibrated on `device`, then replicated once onto each
    other device of the mesh."""
    kind = cfg.model.kind
    tasks = {"two_stream": SegmentTask, "two_stream_window": SegmentWindowTask}
    if kind != "text" and kind not in tasks:
        raise SystemExit(f"unknown model.kind {kind}")
    if calib_clips is not None and kind == "text":
        raise SystemExit("int8 vision serving needs a two-stream scorer "
                         "(got model.kind=text)")
    dev = resolve_device(device)
    hw = 64 if args.tiny else 224  # train_segment's frame contract
    if kind == "text":
        task = SegmentTextTask(cfg, tiny=args.tiny,
                               vocab_size=tokenizer.vocab_size)
    else:
        bert_cfg = None
        if args.tiny:
            from ..models.bert import BertConfig

            bert_cfg = BertConfig.tiny(vocab_size=tokenizer.vocab_size)
        task = tasks[kind](cfg, tiny=args.tiny, hw=hw, bert_cfg=bert_cfg)
    task.contract = dict(task.contract, vocab_hash=vocab_hash(tokenizer))

    ckpt = CheckpointManager(cfg.train.ckpt_dir)
    # the best of this kind by score; with no scores saved, the newest
    restored = ckpt.restore_best(kind)
    if restored is not None:
        step, state = restored
        # a train/eval config divergence fails loudly (the JAX package's
        # round-4 silent-zero-vision class of bug)
        assert_contract(ckpt.metrics_for(step).get("contract"),
                        task.contract, context="eval_segment")
        weights = state["model"]
        print(f"restored checkpoint at epoch {step} (step {state['step']})")
    else:
        weights = task.init_state()
        print(f"no checkpoint in {cfg.train.ckpt_dir}: random weights "
              f"(train.seed={cfg.train.seed})")
    model = task.model
    model.load_state_dict(weights, assign=True)
    if kind == "text":
        model = model.to(dev, task.dtype).eval()
        if mesh is not None:
            return make_sharded_text_score_fn(model, mesh)
        return make_text_score_fn(model, dev)
    model.to_serving(dev)

    quant = None
    if calib_clips is not None:
        quant = calibrate_two_stream_quant(
            model, torch.from_numpy(np.ascontiguousarray(calib_clips)).to(dev))
    if cfg.model.kind == "two_stream_window":
        if mesh is not None:
            return make_sharded_window_score_fn(model, mesh,
                                                quant_scales=quant)
        return make_window_score_fn(model, dev, quant_scales=quant)
    if mesh is not None:
        return make_sharded_two_stream_score_fn(model, mesh,
                                                quant_scales=quant)
    return make_two_stream_score_fn(model, dev, quant_scales=quant)
