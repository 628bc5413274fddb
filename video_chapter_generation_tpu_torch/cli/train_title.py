"""Train the chapter-title generator on the port (counterpart of the JAX
package's cli/train_title.py).

    python -m video_chapter_generation_tpu_torch.cli.train_title \
        data.data_file=... data.train_vid_file=... data.val_vid_file=... \
        [data.title_input_len=512] [data.title_decode_len=30] \
        [--title_arch pegasus|bigbird|bart] [--remat] [--spm_tsv pieces.tsv] \
        [model.vision_init=EMB_DIR] [--tiny] [--device cpu]

Runs on the card unless --device says otherwise; under torchrun
--nproc_per_node=N, data-parallel on N cards with ZeRO-sharded optimizer
state (cli/common.py:TORCHRUN_HELP; train/loop.py). --title_arch picks
Pegasus-large (the default), BigBird-Pegasus-large (block-sparse encoder:
give it data.title_input_len=3072) or BART-large, at the tokenizer's
vocabulary; --tiny their tiny forms. --remat recomputes each encoder and
decoder layer in the backward pass (the JAX CLI measured it slower at
batch 16; it buys memory for larger batches). model.vision_init names a
directory of chapter vision embeddings (cli/extract_vision_emb's output):
the model becomes Seq2SeqVisionEmb with cross-attention fusion and trains
on ChapterTitleVisionEmbDataset. Each epoch samples one random chapter a
video; the eval (every train.eval_every_epochs) is the mean title loss
and token accuracy on the val split. Checkpoints carry the title
contract with the tokenizer's vocab_hash, so cli/infer_video restores
them. Returns the Trainer.
"""

from __future__ import annotations

import dataclasses
import sys

from ..core.contract import vocab_hash
from ..data.datasets import (
    ChapterTitleDataset,
    ChapterTitleVisionEmbDataset,
    npy_vision_emb_provider,
)
from ..data.loader import DataLoader
from ..train.loop import Trainer
from ..train.tasks import TitleGenTask, TitleGenVisionTask
from ..parallel import dist
from .common import (
    TORCHRUN_HELP,
    load_corpus,
    load_title_tokenizer,
    parse_config,
    pop_flag,
    say,
    start_training,
    title_s2s_config,
    train_loader,
)


def main(argv=None) -> Trainer:
    argv = list(argv if argv is not None else sys.argv[1:])
    remat = pop_flag(argv, "--remat", value=False) is not None
    made = start_training()
    cfg, args = parse_config(argv, "train chapter-title generator",
                             TORCHRUN_HELP)
    corpus = load_corpus(cfg, "train")
    val_corpus = load_corpus(cfg, "val")
    tokenizer = load_title_tokenizer(args, corpus)
    s2s = title_s2s_config(args, tokenizer)
    if remat:
        s2s = dataclasses.replace(s2s, remat=True)

    d = cfg.data
    vision_dir = cfg.model.vision_init  # the JAX CLI's reuse of the field
    if vision_dir:
        provider = npy_vision_emb_provider(vision_dir)
        task = TitleGenVisionTask(cfg, s2s)

        def make_ds(c):
            return ChapterTitleVisionEmbDataset(
                c, tokenizer, provider, max_vision_emb=d.max_vision_emb,
                emb_dim=task.vision_emb_size, max_text_len=d.title_input_len,
                chapter_title_text_len=d.title_decode_len,
                seed=cfg.train.seed)
    else:
        task = TitleGenTask(cfg, s2s)

        def make_ds(c):
            return ChapterTitleDataset(c, tokenizer, d.title_input_len,
                                       d.title_decode_len, cfg.train.seed)
    task.contract = dict(task.contract, vocab_hash=vocab_hash(tokenizer))

    loader = train_loader(cfg, DataLoader(make_ds(corpus), d.batch_size,
                                          seed=cfg.train.seed))
    val_loader = DataLoader(make_ds(val_corpus), d.batch_size,
                            shuffle=False, drop_last=False)
    trainer = Trainer(cfg=cfg, task=task, train_loader=loader,
                      eval_loader=val_loader, device=args.device)
    metrics = trainer.train()
    say("final:", metrics)
    if made:
        dist.shutdown()
    return trainer


if __name__ == "__main__":
    main()
