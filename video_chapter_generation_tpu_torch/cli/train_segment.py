"""Train the chapter-boundary model on the port (counterpart of the JAX
package's cli/train_segment.py).

    python -m video_chapter_generation_tpu_torch.cli.train_segment \
        data.img_dir=... data.data_file=... data.train_vid_file=... \
        data.val_vid_file=... model.kind=two_stream model.stem_input=s2d \
        data.batch_size=8 [--bert_vocab vocab.txt] [--tiny] [--device cpu] \
        [--init_streams CKPT_DIR]

Runs on the card unless --device says otherwise. model.kind=two_stream
is ported; two_stream_window and text are not yet (ROADMAP queue 1).
--init_streams warm-starts the text and vision streams from a checkpoint
this CLI wrote. Returns the Trainer.
"""

from __future__ import annotations

import logging
import sys

from ..core.checkpoint import CheckpointManager
from ..core.contract import vocab_hash
from ..data.datasets import ClipDataset
from ..data.loader import DataLoader
from ..models.bert import BertConfig
from ..train.loop import Trainer
from ..train.tasks import SegmentTask
from .common import load_bert_tokenizer, load_corpus, parse_config

NOT_PORTED = {
    "two_stream_window": "the window model is ROADMAP queue 1 item 5",
    "text": "the text-only task is ROADMAP queue 1 item 6 (training)",
}


def _warm_start(task: SegmentTask, ckpt_dir: str) -> None:
    """Replace the task's initial text and vision streams with those of
    the newest checkpoint in ckpt_dir."""
    restored = CheckpointManager(ckpt_dir).restore_raw()
    if restored is None:
        raise SystemExit(f"no checkpoint in {ckpt_dir}")
    step, state = restored
    saved = state["model"]
    base_init = task.init_state

    def init_with_streams():
        sd = base_init()
        for stream in ("lang_model.", "vision_model."):
            keys = [k for k in saved if k.startswith(stream)]
            if not keys:
                raise SystemExit(f"{ckpt_dir} holds no {stream[:-1]}")
            sd.update({k: saved[k] for k in keys})
        return sd

    task.init_state = init_with_streams
    print(f"warm-started lang/vision streams from {ckpt_dir} (epoch {step})")


def main(argv=None) -> Trainer:
    argv = list(argv if argv is not None else sys.argv[1:])
    init_streams = None
    if "--init_streams" in argv:
        i = argv.index("--init_streams")
        init_streams = argv[i + 1]
        del argv[i:i + 2]
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s "
                               "%(message)s")
    cfg, args = parse_config(argv, "train chapter-boundary model")
    kind = cfg.model.kind
    if kind in NOT_PORTED:
        raise SystemExit(f"model.kind={kind} is not ported to the PyTorch "
                         f"port yet: {NOT_PORTED[kind]}")
    if kind != "two_stream":
        raise SystemExit(f"unknown model.kind {kind}")
    corpus = load_corpus(cfg, "train")
    val_corpus = load_corpus(cfg, "val")
    tokenizer = load_bert_tokenizer(args, corpus)

    hw = 64 if args.tiny else 224
    # the tiny BERT takes the tokenizer's vocabulary (an out-of-range id
    # raises in torch where a JAX lookup would clamp it)
    bert_cfg = (BertConfig.tiny(vocab_size=tokenizer.vocab_size)
                if args.tiny else None)
    task = SegmentTask(cfg, tiny=args.tiny, hw=hw, bert_cfg=bert_cfg)
    task.contract = dict(task.contract, vocab_hash=vocab_hash(tokenizer))
    if init_streams:
        _warm_start(task, init_streams)

    def make_ds(c):
        return ClipDataset(c, tokenizer, cfg.data.clip_frame_num,
                           cfg.data.max_text_len, cfg.model.data_mode,
                           cfg.data.fps, cfg.train.seed, hw,
                           s2d=cfg.model.stem_input == "s2d")

    train_loader = DataLoader(make_ds(corpus), cfg.data.batch_size,
                              seed=cfg.train.seed)
    val_loader = DataLoader(make_ds(val_corpus), cfg.data.batch_size,
                            shuffle=False, drop_last=False)
    trainer = Trainer(cfg=cfg, task=task, train_loader=train_loader,
                      eval_loader=val_loader, device=args.device)
    metrics = trainer.train()
    print("final:", metrics, "best:", trainer.best_result)
    return trainer


if __name__ == "__main__":
    main()
