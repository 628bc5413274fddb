"""Train the chapter-boundary model on the port (counterpart of the JAX
package's cli/train_segment.py).

    python -m video_chapter_generation_tpu_torch.cli.train_segment \
        data.img_dir=... data.data_file=... data.train_vid_file=... \
        data.val_vid_file=... [model.kind=two_stream] [model.tsm_impl=...] \
        data.batch_size=8 [--bert_vocab vocab.txt] [--tiny] [--device cpu] \
        [--init_streams CKPT_DIR]

Runs on the card unless --device says otherwise; under torchrun
--nproc_per_node=N, data-parallel on N cards (cli/common.py
:TORCHRUN_HELP; train/loop.py), only the primary process printing and
writing logs and checkpoints. model.kind defaults to
two_stream_window, the window model (JAX cli/train_segment.py:47-53);
two_stream is the base model; text the subtitle-only BertForChapter
(:60-66, clips without frames). --init_streams warm-starts the text and
vision streams from a checkpoint this CLI wrote, of a two-stream model.
Returns the Trainer.
"""

from __future__ import annotations

import sys

from ..core.checkpoint import CheckpointManager
from ..core.contract import vocab_hash
from ..data.datasets import ClipDataset, WindowClipDataset
from ..data.loader import DataLoader
from ..models.bert import BertConfig
from ..train.loop import Trainer
from ..train.tasks import SegmentTask, SegmentTextTask, SegmentWindowTask
from ..parallel import dist
from .common import (
    TORCHRUN_HELP,
    load_bert_tokenizer,
    load_corpus,
    parse_config,
    say,
    start_training,
    train_loader,
)

TASKS = {"two_stream_window": SegmentWindowTask, "two_stream": SegmentTask}


def _warm_start(task, ckpt_dir: str) -> None:
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
    say(f"warm-started lang/vision streams from {ckpt_dir} (epoch {step})")


def main(argv=None) -> Trainer:
    argv = list(argv if argv is not None else sys.argv[1:])
    init_streams = None
    if "--init_streams" in argv:
        i = argv.index("--init_streams")
        init_streams = argv[i + 1]
        del argv[i:i + 2]
    made = start_training()
    cfg, args = parse_config(argv, "train chapter-boundary model",
                             TORCHRUN_HELP)
    kind = cfg.model.kind
    if kind != "text" and kind not in TASKS:
        raise SystemExit(f"unknown model.kind {kind}")
    corpus = load_corpus(cfg, "train")
    val_corpus = load_corpus(cfg, "val")
    tokenizer = load_bert_tokenizer(args, corpus)

    hw = 64 if args.tiny else 224
    # the tiny BERT takes the tokenizer's vocabulary (an out-of-range id
    # raises in torch where a JAX lookup would clamp it)
    bert_cfg = (BertConfig.tiny(vocab_size=tokenizer.vocab_size)
                if args.tiny else None)
    if kind == "text":
        task = SegmentTextTask(cfg, tiny=args.tiny,
                               vocab_size=tokenizer.vocab_size)
    else:
        try:
            task = TASKS[kind](cfg, tiny=args.tiny, hw=hw, bert_cfg=bert_cfg)
        except ValueError as e:  # a model config the port refuses
            raise SystemExit(f"model config refused: {e}") from e
    task.contract = dict(task.contract, vocab_hash=vocab_hash(tokenizer))
    if init_streams:
        _warm_start(task, init_streams)

    d, s2d = cfg.data, cfg.model.stem_input == "s2d"

    def make_ds(c):
        if kind == "two_stream_window":
            return WindowClipDataset(c, tokenizer, d.clip_frame_num,
                                     d.max_text_len, d.window_size,
                                     cfg.model.data_mode, d.fps,
                                     cfg.train.seed, hw, s2d=s2d)
        mode = "text" if kind == "text" else cfg.model.data_mode
        return ClipDataset(c, tokenizer, d.clip_frame_num, d.max_text_len,
                           mode, d.fps, cfg.train.seed, hw,
                           s2d=s2d and kind != "text")

    loader = train_loader(cfg, DataLoader(make_ds(corpus),
                                          cfg.data.batch_size,
                                          seed=cfg.train.seed))
    val_loader = DataLoader(make_ds(val_corpus), cfg.data.batch_size,
                            shuffle=False, drop_last=False)
    trainer = Trainer(cfg=cfg, task=task, train_loader=loader,
                      eval_loader=val_loader, device=args.device)
    metrics = trainer.train()
    say("final:", metrics, "best:", trainer.best_result)
    if made:
        dist.shutdown()
    return trainer


if __name__ == "__main__":
    main()
