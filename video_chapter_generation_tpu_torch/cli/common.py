"""Shared CLI plumbing (counterpart of the JAX package's cli/common.py):
config parsing, corpus and tokenizer construction, the title model's
configuration."""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import List, Optional, Tuple

from ..core.config import Config
from ..data.corpus import VideoCorpus
from ..data.tokenization import UnigramTokenizer, WordPieceTokenizer
from ..models.seq2seq import Seq2SeqConfig

# --title_arch values the port does not serve yet, with their ROADMAP item
TITLE_ARCH_NOT_PORTED = {
    "bigbird": "the BigBird title model is ROADMAP queue 1 item 9 "
               "(with kernel K10, queue 2)",
    "bart": "the BART title model is ROADMAP queue 1 item 9",
}


def parse_config(argv: Optional[List[str]] = None,
                 description: str = "") -> Tuple[Config, argparse.Namespace]:
    """Flags: --config <json file>, --bert_vocab, --spm_tsv, --tiny,
    --title_arch, --device, plus any number of a.b=c overrides
    (cli/common.py:22)."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--config", type=str, default=None,
                        help="JSON config file")
    parser.add_argument("--bert_vocab", type=str, default=None,
                        help="path to a BERT vocab.txt")
    parser.add_argument("--spm_tsv", type=str, default=None,
                        help="path to a sentencepiece piece<TAB>score export")
    parser.add_argument("--title_arch", type=str, default="pegasus",
                        choices=("pegasus", "bigbird", "bart"),
                        help="title-model family; the port serves pegasus")
    parser.add_argument("--tiny", action="store_true",
                        help="tiny model configs (CI / smoke)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: cuda when present)")
    parser.add_argument("overrides", nargs="*", help="a.b=c overrides")
    args = parser.parse_args(argv)
    cfg = Config()
    if args.config:
        with open(args.config) as f:
            cfg = Config.from_dict(json.load(f))
    if args.overrides:
        cfg = cfg.apply_overrides(args.overrides)
    return cfg, args


def load_corpus(cfg: Config, split: str = "train") -> VideoCorpus:
    """The corpus of one split (cli/common.py:58)."""
    vid_file = {"train": cfg.data.train_vid_file,
                "val": cfg.data.val_vid_file,
                "test": cfg.data.test_vid_file}[split]
    return VideoCorpus.from_files(cfg.data.img_dir, cfg.data.data_file,
                                  vid_file, cfg.data.subtitle_dir)


def load_bert_tokenizer(args, corpus: Optional[VideoCorpus] = None):
    """A vocab file's WordPiece tokenizer, else one built from the corpus's
    subtitles (cli/common.py:69)."""
    if args.bert_vocab:
        return WordPieceTokenizer.from_vocab_file(args.bert_vocab)
    if corpus is not None:
        texts = []
        for vid in corpus.vids[:200]:
            texts += [s["text"] for s in corpus.subtitles(vid)]
        return WordPieceTokenizer.build_from_corpus(texts, vocab_size=8000)
    raise SystemExit("--bert_vocab required (no corpus to build one from)")


def title_s2s_config(args, tokenizer) -> Seq2SeqConfig:
    """The title model's Seq2SeqConfig (cli/common.py:80-112): Pegasus-large,
    or the tiny Pegasus with --tiny, at the tokenizer's vocabulary size.
    --title_arch bigbird|bart exit naming their ROADMAP item."""
    arch = getattr(args, "title_arch", "pegasus")
    if arch in TITLE_ARCH_NOT_PORTED:
        raise SystemExit(f"--title_arch {arch} is not ported to the PyTorch "
                         f"port yet: {TITLE_ARCH_NOT_PORTED[arch]}")
    if args.tiny:
        return Seq2SeqConfig.tiny(vocab_size=tokenizer.vocab_size)
    return dataclasses.replace(Seq2SeqConfig.pegasus_large(),
                               vocab_size=tokenizer.vocab_size)


def load_title_tokenizer(args, corpus: Optional[VideoCorpus] = None):
    """The --spm_tsv unigram tokenizer, else one built from the corpus's
    subtitles (cli/common.py:115-123)."""
    if args.spm_tsv:
        return UnigramTokenizer.from_tsv(args.spm_tsv)
    if corpus is not None:
        texts = []
        for vid in corpus.vids[:200]:
            texts += [s["text"] for s in corpus.subtitles(vid)]
        return UnigramTokenizer.build_from_corpus(texts, vocab_size=8000)
    raise SystemExit("--spm_tsv required (no corpus to build one from)")
