"""Subtitle language-model pretraining of the BERT stack on the port
(counterpart of the JAX package's cli/pretrain_lang.py).

    python -m video_chapter_generation_tpu_torch.cli.pretrain_lang \
        data.data_file=... data.subtitle_dir=... data.train_vid_file=... \
        [--task mlm|next_token] [--bert_vocab vocab.txt] [--tiny] \
        [--device cpu]

Runs on the card unless --device says otherwise. Each epoch takes one
random 16 s subtitle window a video (SubtitlePretrainDataset) and trains
BertForChapter with its vocabulary head (LangPretrainTask): --task mlm
(the default) corrupts 15% of the tokens BERT's way and predicts them;
--task next_token predicts each token's successor with the same
bidirectional BERT, as the JAX CLI does. Checkpoints carry the
"lang_pretrain" contract with the tokenizer's vocab_hash. The GPT tasks
(next_token_gpt, next_token_glove) exit naming their ROADMAP item.
Returns the Trainer.
"""

from __future__ import annotations

import logging
import sys

from ..core.contract import vocab_hash
from ..data.datasets import SubtitlePretrainDataset
from ..data.loader import DataLoader
from ..train.loop import Trainer
from ..train.tasks import LangPretrainTask
from .common import load_bert_tokenizer, load_corpus, parse_config, pop_flag

TASKS = ("mlm", "next_token")
NOT_PORTED = {
    "next_token_gpt": "the from-scratch GPT is ROADMAP queue 1 item 12",
    "next_token_glove": "the from-scratch GPT on GloVe embeddings is "
                        "ROADMAP queue 1 item 12",
}


def main(argv=None) -> Trainer:
    argv = list(argv if argv is not None else sys.argv[1:])
    task_name = pop_flag(argv, "--task") or "mlm"
    if task_name in NOT_PORTED:
        raise SystemExit(f"--task {task_name} is not ported to the PyTorch "
                         f"port yet: {NOT_PORTED[task_name]}")
    if task_name not in TASKS:
        raise SystemExit(f"--task {task_name}: one of "
                         f"{', '.join(TASKS + tuple(NOT_PORTED))}")
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s "
                               "%(message)s")
    cfg, args = parse_config(argv, "subtitle LM pretraining")
    corpus = load_corpus(cfg, "train")
    tokenizer = load_bert_tokenizer(args, corpus)
    task = LangPretrainTask(cfg, vocab_size=tokenizer.vocab_size,
                            tiny=args.tiny)
    task.contract = dict(task.contract, vocab_hash=vocab_hash(tokenizer))
    ds = SubtitlePretrainDataset(corpus, tokenizer, task=task_name,
                                 max_text_len=cfg.data.max_text_len,
                                 seed=cfg.train.seed)
    loader = DataLoader(ds, cfg.data.batch_size, seed=cfg.train.seed)
    trainer = Trainer(cfg=cfg, task=task, train_loader=loader,
                      device=args.device)
    print("final:", trainer.train())
    return trainer


if __name__ == "__main__":
    main()
