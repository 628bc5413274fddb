"""Subtitle language-model pretraining on the port: the BERT stack and
the from-scratch GPT (counterpart of the JAX package's
cli/pretrain_lang.py).

    python -m video_chapter_generation_tpu_torch.cli.pretrain_lang \
        data.data_file=... data.subtitle_dir=... data.train_vid_file=... \
        [--task mlm|next_token|next_token_gpt|next_token_glove] \
        [--bert_vocab vocab.txt] [--glove emb.txt|emb.pkl] \
        [--glove_vocab words.txt] [--tiny] [--device cpu]

Runs on the card unless --device says otherwise; under torchrun
--nproc_per_node=N, data-parallel on N cards (cli/common.py
:TORCHRUN_HELP; train/loop.py). Each epoch takes one
random 16 s subtitle window a video. --task mlm (the default) and
--task next_token train BertForChapter with its vocabulary head
(SubtitlePretrainDataset, LangPretrainTask): mlm corrupts 15% of the
tokens BERT's way and predicts them, next_token predicts each token's
successor with the same bidirectional BERT, as the JAX CLI does; their
checkpoints carry the "lang_pretrain" contract with the tokenizer's
vocab_hash. --task next_token_gpt trains the from-scratch GPT on word
ids (WordIdSubtitleDataset, GptPretrainTask: 12 layers, 10 heads, 300
wide), over the words of --glove_vocab (one a line) or, without it, of
the corpus's subtitles; --task next_token_glove feeds it the --glove
file's word embeddings (a GloVe text file or a pickle of word -> vector;
GloveSubtitleDataset, GptGlovePretrainTask: 12 heads, the embeddings'
width) over the words of --glove_vocab or, without it, every word of the
table. Their checkpoints carry "gpt_pretrain" and "gpt_glove_pretrain"
with the word list's vocab_hash; cli/sample_lang samples from them.
Returns the Trainer.
"""

from __future__ import annotations

import sys
from typing import Dict, List

import numpy as np

from ..core.contract import vocab_hash
from ..data.datasets import (
    GloveSubtitleDataset,
    SubtitlePretrainDataset,
    WordIdSubtitleDataset,
)
from ..data.loader import DataLoader
from ..datasetkit.glove import (
    build_word_vocab,
    load_glove_pickle,
    load_glove_txt,
)
from ..train.loop import Trainer
from ..train.tasks import (
    GptGlovePretrainTask,
    GptPretrainTask,
    LangPretrainTask,
)
from ..parallel import dist
from .common import (
    TORCHRUN_HELP,
    load_bert_tokenizer,
    load_corpus,
    parse_config,
    pop_flag,
    say,
    start_training,
    train_loader,
)

TASKS = ("mlm", "next_token", "next_token_gpt", "next_token_glove")


def load_word_vocab(glove_vocab, corpus) -> List[str]:
    """The word-level vocabulary: the file's words (one a line), else the
    corpus's (JAX cli/pretrain_lang.py:36-43)."""
    if glove_vocab:
        with open(glove_vocab) as f:
            return [x.strip() for x in f if x.strip()]
    return build_word_vocab(corpus)


def load_glove(path: str) -> Dict[str, np.ndarray]:
    """A GloVe table from a pickle (.pkl, .pickle) or a text file."""
    if path.endswith((".pkl", ".pickle")):
        return load_glove_pickle(path)
    return load_glove_txt(path)


def main(argv=None) -> Trainer:
    argv = list(argv if argv is not None else sys.argv[1:])
    task_name = pop_flag(argv, "--task") or "mlm"
    glove_path = pop_flag(argv, "--glove")
    glove_vocab = pop_flag(argv, "--glove_vocab")
    if task_name not in TASKS:
        raise SystemExit(f"--task {task_name}: one of {', '.join(TASKS)}")
    if task_name == "next_token_glove" and not glove_path:
        raise SystemExit("--task next_token_glove needs --glove FILE (a GloVe "
                         "text file or a pickle of word -> vector)")
    made = start_training()
    cfg, args = parse_config(argv, "subtitle LM pretraining", TORCHRUN_HELP)
    corpus = load_corpus(cfg, "train")
    d = cfg.data
    if task_name == "next_token_gpt":
        vocab = load_word_vocab(glove_vocab, corpus)
        task = GptPretrainTask(cfg, vocab_size=len(vocab), tiny=args.tiny)
        ds = WordIdSubtitleDataset(corpus, vocab,
                                   clip_frame_num=d.clip_frame_num,
                                   max_text_len=d.max_text_len,
                                   seed=cfg.train.seed)
        hashed = vocab
    elif task_name == "next_token_glove":
        table = load_glove(glove_path)
        vocab = (load_word_vocab(glove_vocab, corpus) if glove_vocab
                 else sorted(table))
        emb_dim = len(next(iter(table.values())))
        task = GptGlovePretrainTask(cfg, vocab_size=len(vocab),
                                    tiny=args.tiny, emb_dim=emb_dim)
        ds = GloveSubtitleDataset(corpus, table, vocab,
                                  clip_frame_num=d.clip_frame_num,
                                  max_text_len=d.max_text_len,
                                  emb_dim=emb_dim, seed=cfg.train.seed)
        hashed = vocab
    else:
        hashed = load_bert_tokenizer(args, corpus)
        task = LangPretrainTask(cfg, vocab_size=hashed.vocab_size,
                                tiny=args.tiny)
        ds = SubtitlePretrainDataset(corpus, hashed, task=task_name,
                                     max_text_len=d.max_text_len,
                                     seed=cfg.train.seed)
    task.contract = dict(task.contract, vocab_hash=vocab_hash(hashed))
    loader = train_loader(cfg, DataLoader(ds, d.batch_size,
                                          seed=cfg.train.seed))
    trainer = Trainer(cfg=cfg, task=task, train_loader=loader,
                      device=args.device)
    say("final:", trainer.train())
    if made:
        dist.shutdown()
    return trainer


if __name__ == "__main__":
    main()
