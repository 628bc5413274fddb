"""ListNet listwise finetuning on the port (counterpart of the JAX
package's cli/train_listwise.py): slates of 1 positive clip and 1
positive + 4 negative contrast clips a video, the ListNet top-1 loss
plus the binary head's cross entropy over every slate row.

    python -m video_chapter_generation_tpu_torch.cli.train_listwise \
        data.data_file=... data.subtitle_dir=... data.train_vid_file=... \
        [--bert_vocab vocab.txt] [--tiny] [--device cpu]

Runs on the card unless --device says otherwise. BERT-base (or the tiny
one with --tiny) at the tokenizer's vocabulary: the JAX CLI builds
BERT-base at 30,522 entries whatever its tokenizer holds. AdamW at
optim.learning_rate, the gradient clipped to optim.grad_norm_clip. BERT
runs without dropout, in model.compute_dtype (bf16 under autocast on the
card; the JAX CLI trains in float32). Prints one line an epoch, as the
JAX CLI does; returns the ListwiseBert.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict

import numpy as np
import torch

from ..data.datasets import ListwiseSlateDataset
from ..data.loader import DataLoader
from ..device import resolve_device
from ..models import convert
from ..models.bert import BertConfig
from ..models.contrastive import ListwiseBert
from ..train.optim import clipped_step, make_optimizer
from ..train.tasks import compute_dtype
from .common import load_bert_tokenizer, load_corpus, parse_config


def build_model(bert_cfg: BertConfig, dtype: torch.dtype, seed: int,
                device) -> ListwiseBert:
    """ListwiseBert with init_state(seed)'s weights on device (float64
    weights under a float64 compute dtype, else float32)."""
    with torch.device("meta"):
        lw = ListwiseBert(bert_cfg, dtype=dtype)
    lw.load_state_dict(lw.init_state(seed), assign=True)
    if dtype == torch.float64:
        lw.double()
    return lw.to(device)


def listwise_step(lw: ListwiseBert, opt: torch.optim.Optimizer,
                  batch: Dict[str, np.ndarray], max_norm: float
                  ) -> Dict[str, torch.Tensor]:
    """One update on a host batch of slates; the binary head covers every
    slate row -> train_forward's outputs, detached."""
    dev = lw.head.weight.device
    t = {k: torch.as_tensor(np.asarray(v)).to(dev) for k, v in batch.items()}
    b, s, _ = t["text_ids"].shape
    opt.zero_grad(set_to_none=True)
    out = lw.train_forward(t["text_ids"], t["attention_mask"], t["relevance"],
                           torch.arange(b * s, device=dev),
                           t["slate_labels"].reshape(-1))
    out["loss"].backward()
    clipped_step(opt, lw.parameters(), max_norm)
    return {k: v.detach() for k, v in out.items()}


def main(argv=None) -> ListwiseBert:
    cfg, args = parse_config(argv, "listwise (ListNet) finetuning")
    dev = resolve_device(args.device)
    corpus = load_corpus(cfg, "train")
    tokenizer = load_bert_tokenizer(args, corpus)
    base = BertConfig.tiny() if args.tiny else BertConfig()
    bert_cfg = dataclasses.replace(base, vocab_size=tokenizer.vocab_size)
    lw = build_model(bert_cfg, compute_dtype(cfg), cfg.train.seed, dev)
    opt = make_optimizer(cfg.optim, lw,
                         convert.listwise_bert_entries(bert_cfg.num_layers))

    ds = ListwiseSlateDataset(corpus, tokenizer, cfg.data.clip_frame_num,
                              cfg.data.max_text_len, seed=cfg.train.seed)
    loader = DataLoader(ds, cfg.data.batch_size, seed=cfg.train.seed)
    for epoch in range(cfg.train.max_epochs):
        t0 = time.time()
        losses = []
        for batch in loader(epoch):
            losses.append(float(listwise_step(
                lw, opt, batch, cfg.optim.grad_norm_clip)["loss"]))
        print(f"epoch {epoch}: loss {np.mean(losses):.4f} "
              f"({time.time() - t0:.1f}s)", flush=True)
    return lw


if __name__ == "__main__":
    main()
