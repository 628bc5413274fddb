"""Shared CLI plumbing (counterpart of the JAX package's cli/common.py):
config parsing, corpus and tokenizer construction."""

from __future__ import annotations

import argparse
import json
from typing import List, Optional, Tuple

from ..core.config import Config
from ..data.corpus import VideoCorpus
from ..data.tokenization import WordPieceTokenizer


def parse_config(argv: Optional[List[str]] = None,
                 description: str = "") -> Tuple[Config, argparse.Namespace]:
    """Flags: --config <json file>, --bert_vocab, --tiny, --device, plus any
    number of a.b=c overrides (cli/common.py:22)."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--config", type=str, default=None,
                        help="JSON config file")
    parser.add_argument("--bert_vocab", type=str, default=None,
                        help="path to a BERT vocab.txt")
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
