"""Shared CLI plumbing (counterpart of the JAX package's cli/common.py):
config parsing, corpus and tokenizer construction, the title model's
configuration."""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
from typing import List, Optional, Tuple

from ..core.config import Config
from ..data.corpus import VideoCorpus
from ..data.tokenization import UnigramTokenizer, WordPieceTokenizer
from ..data.loader import DataLoader
from ..models.seq2seq import Seq2SeqConfig
from ..parallel import dist
from ..parallel.loader import rank_loader

# the training CLIs' --help epilogue
TORCHRUN_HELP = ("Under torchrun --nproc_per_node=N (or any launcher that "
                 "sets RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT, "
                 "LOCAL_RANK and LOCAL_WORLD_SIZE) the N processes train "
                 "data-parallel, each on its card (cuda:LOCAL_RANK), the "
                 "global batch data.batch_size split over them: the same "
                 "steps as one process on one card.")


def pop_flag(argv: List[str], flag: str, value: bool = True
             ) -> Optional[str]:
    """Remove `flag` (and its value) from argv: its value, "" for a bare
    flag, None when absent (the JAX CLIs' hand-parsed flags)."""
    if flag not in argv:
        return None
    i = argv.index(flag)
    out = argv[i + 1] if value else ""
    del argv[i:i + (2 if value else 1)]
    return out


def start_training() -> bool:
    """A training CLI's start: join the launcher's process group, if any
    (True where this call made it: the CLI then owns the shutdown), and
    log at INFO on the primary process only."""
    made = dist.initialize()
    logging.basicConfig(level=logging.INFO if dist.is_primary()
                        else logging.WARNING,
                        format="%(asctime)s %(name)s %(levelname)s "
                               "%(message)s")
    return made


def train_loader(cfg: Config, loader: DataLoader) -> DataLoader:
    """This process's rows of the global batches (parallel/loader.py):
    the loader itself alone."""
    index, count = dist.data_coords(cfg.mesh.model_axis)
    return rank_loader(loader, index, count)


def say(*args) -> None:
    """print on the primary process only."""
    if dist.is_primary():
        print(*args)


def parse_config(argv: Optional[List[str]] = None,
                 description: str = "",
                 epilog: Optional[str] = None
                 ) -> Tuple[Config, argparse.Namespace]:
    """Flags: --config <json file>, --bert_vocab, --spm_tsv, --tiny,
    --title_arch, --device, plus any number of a.b=c overrides, before,
    between or after the flags (cli/common.py:22, whose parser takes
    them only in one run)."""
    parser = argparse.ArgumentParser(description=description, epilog=epilog)
    parser.add_argument("--config", type=str, default=None,
                        help="JSON config file")
    parser.add_argument("--bert_vocab", type=str, default=None,
                        help="path to a BERT vocab.txt")
    parser.add_argument("--spm_tsv", type=str, default=None,
                        help="path to a sentencepiece piece<TAB>score export")
    parser.add_argument("--title_arch", type=str, default="pegasus",
                        choices=("pegasus", "bigbird", "bart"),
                        help="title-model family; bigbird = block-sparse "
                        "long-context encoder: raise data.title_input_len "
                        "(e.g. 3072) to use it (at 512 its encoder falls "
                        "back to full attention)")
    parser.add_argument("--tiny", action="store_true",
                        help="tiny model configs (CI / smoke)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the card, cuda; "
                        "pass cpu to run on the CPU)")
    parser.add_argument("overrides", nargs="*", help="a.b=c overrides")
    # overrides may stand anywhere among the flags ("... --title_arch
    # bigbird data.title_input_len=3072"); plain parse_args refuses a
    # positional that follows a flag once the positionals were consumed
    args = parser.parse_intermixed_args(argv)
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
    """The title model's Seq2SeqConfig for --title_arch at the selected
    size, at the tokenizer's vocabulary size (cli/common.py:80-112):
    Pegasus-large, BigBird-Pegasus-large or BART-large, or their tiny
    forms with --tiny (the tiny BigBird has 16-token blocks, 1 random
    block and 256 positions, so it is sparse from title_input_len=128)."""
    arch = getattr(args, "title_arch", "pegasus")
    if args.tiny:
        kw = dict(vocab_size=tokenizer.vocab_size)
        if arch == "bigbird":
            kw.update(
                max_positions=256, encoder_attention="block_sparse",
                block_size=16, num_rand_blocks=1, activation="gelu_new",
                learned_positions=True, decoder_start_token_id=2,
                attention_bias=False)
        elif arch == "bart":
            kw.update(
                activation="gelu", pre_norm=False, learned_positions=True,
                position_offset=2, scale_embedding=False,
                embed_layernorm=True)
        return Seq2SeqConfig.tiny(**kw)
    base = {"pegasus": Seq2SeqConfig.pegasus_large,
            "bigbird": Seq2SeqConfig.bigbird_pegasus_large,
            "bart": Seq2SeqConfig.bart_large}[arch]()
    return dataclasses.replace(base, vocab_size=tokenizer.vocab_size)


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
