"""The boundary scorer from a checkpoint (counterpart of the JAX
package's cli/eval_segment.py). Of that CLI, `build_score_fn` (:109-200)
is ported, for every model.kind: two_stream, two_stream_window and text
(:139-144, 189-200); the evaluation itself (AUC/mAP and cut-point P/R/F
files) is ROADMAP queue 1 item 11.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.checkpoint import CheckpointManager
from ..core.contract import assert_contract, vocab_hash
from ..device import resolve_device
from ..ops.quantize import calibrate_two_stream_quant
from ..pipeline.boundary import (
    make_text_score_fn,
    make_two_stream_score_fn,
    make_window_score_fn,
)
from ..train.tasks import SegmentTask, SegmentTextTask, SegmentWindowTask


def build_score_fn(cfg, args, tokenizer,
                   calib_clips: Optional[np.ndarray] = None, device=None):
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
    batches (text_ids and attention_mask only for text)."""
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
        return make_text_score_fn(model.to(dev, task.dtype).eval(), dev)
    model.to_serving(dev)

    quant = None
    if calib_clips is not None:
        quant = calibrate_two_stream_quant(
            model, torch.from_numpy(np.ascontiguousarray(calib_clips)).to(dev))
    if cfg.model.kind == "two_stream_window":
        return make_window_score_fn(model, dev, quant_scales=quant)
    return make_two_stream_score_fn(model, dev, quant_scales=quant)
