"""Export tokenizer assets from HuggingFace files into the port's
tokenizer formats (no network). The port's own copy of
video_chapter_generation_tpu/cli/export_tokenizer.py (each definition
names the line it was copied from):

- a fast-tokenizer `tokenizer.json` with a WordPiece model -> vocab.txt
  (for WordPieceTokenizer.from_vocab_file)
- a `tokenizer.json` with a Unigram model (Pegasus/T5-style) ->
  piece<TAB>score TSV (for UnigramTokenizer.from_tsv)
- a plain vocab.txt passes through unchanged

    python -m video_chapter_generation_tpu_torch.cli.export_tokenizer \
        --input bert/tokenizer.json --out vocab.txt
"""

from __future__ import annotations

import argparse
import json
import shutil
from typing import List, Optional


def export(input_path: str, out_path: str) -> str:
    """Copied from video_chapter_generation_tpu/cli/export_tokenizer.py:22."""
    if input_path.endswith("vocab.txt"):
        shutil.copy(input_path, out_path)
        return "vocab"

    with open(input_path, encoding="utf-8") as f:
        data = json.load(f)
    model = data.get("model", {})
    mtype = model.get("type")

    if mtype == "WordPiece":
        vocab = model["vocab"]  # token -> id
        tokens = [None] * len(vocab)
        for tok, idx in vocab.items():
            tokens[idx] = tok
        with open(out_path, "w", encoding="utf-8") as f:
            f.write("\n".join(tokens) + "\n")
        return "wordpiece"

    if mtype == "Unigram":
        vocab = model["vocab"]  # [[piece, score], ...]
        with open(out_path, "w", encoding="utf-8") as f:
            for piece, score in vocab:
                f.write(f"{piece}\t{score}\n")
        return "unigram"

    raise SystemExit(f"unsupported tokenizer model type: {mtype}")


def main(argv: Optional[List[str]] = None):
    """Copied from video_chapter_generation_tpu/cli/export_tokenizer.py:51."""
    p = argparse.ArgumentParser()
    p.add_argument("--input", required=True,
                   help="tokenizer.json or vocab.txt")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    kind = export(args.input, args.out)
    print(f"exported {kind} vocab to {args.out}")


if __name__ == "__main__":
    main()
