"""MoCo contrastive subtitle pretraining on the port (counterpart of the
JAX package's cli/pretrain_contrastive.py).

    python -m video_chapter_generation_tpu_torch.cli.pretrain_contrastive \
        data.data_file=... data.subtitle_dir=... data.train_vid_file=... \
        [--bert_vocab vocab.txt] [--tiny] [--device cpu]

Runs on the card unless --device says otherwise. The query BERT (BERT-base,
or the tiny one with --tiny, at the tokenizer's vocabulary) trains
against a momentum key encoder (m 0.999) and a queue of 65,536 negatives
(256 with --tiny), temperature 0.07, on ContrastiveSubtitleDataset items
with 4 positive candidates each; AdamW on the query encoder at
optim.learning_rate (the JAX CLI never moves its lr_mult), its gradient
clipped to optim.grad_norm_clip. BERT runs without dropout, in
model.compute_dtype (bf16 under autocast on the card; the JAX CLI trains
in float32 whatever the config says). Prints one line an epoch, as the
JAX CLI does; returns the MoCoTextEncoder.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..data.datasets import ContrastiveSubtitleDataset
from ..data.loader import DataLoader
from ..device import resolve_device
from ..models import convert
from ..models.bert import BertConfig
from ..models.contrastive import MoCoTextEncoder
from ..train.optim import clipped_step, make_optimizer
from ..train.tasks import compute_dtype
from .common import load_bert_tokenizer, load_corpus, parse_config

NUM_CANDIDATES, MOMENTUM, TEMPERATURE = 4, 0.999, 0.07


def build_encoder(bert_cfg: BertConfig, K: int, dtype: torch.dtype,
                  seed: int, device) -> MoCoTextEncoder:
    """The encoder with init_state(seed)'s weights on device (float64
    weights under a float64 compute dtype, else float32)."""
    with torch.device("meta"):
        enc = MoCoTextEncoder(bert_cfg, K=K, m=MOMENTUM, T=TEMPERATURE,
                              dtype=dtype)
    enc.load_state_dict(enc.init_state(seed), assign=True)
    enc.encoder_k.requires_grad_(False)
    if dtype == torch.float64:
        enc.double()
    return enc.to(device)


def moco_step(enc: MoCoTextEncoder, opt: torch.optim.Optimizer,
              batch: Dict[str, np.ndarray], max_norm: float):
    """One MoCo step (the order of MoCoTextEncoder's docstring) on a host
    batch -> (loss, acc, logits), detached."""
    dev = enc.queue.device
    t = {k: torch.as_tensor(np.asarray(v)).to(dev) for k, v in batch.items()}
    opt.zero_grad(set_to_none=True)
    logits, labels, keys = enc(t["query_ids"], t["query_mask"],
                               t["cand_ids"], t["cand_mask"])
    loss = F.cross_entropy(logits, labels)
    acc = (logits.argmax(-1) == 0).to(logits.dtype).mean()
    loss.backward()
    clipped_step(opt, enc.encoder_q.parameters(), max_norm)
    enc.dequeue_and_enqueue(keys)
    return loss.detach(), acc, logits.detach()


def main(argv=None) -> MoCoTextEncoder:
    cfg, args = parse_config(argv, "MoCo contrastive pretraining")
    dev = resolve_device(args.device)
    corpus = load_corpus(cfg, "train")
    tokenizer = load_bert_tokenizer(args, corpus)
    base = BertConfig.tiny() if args.tiny else BertConfig()
    bert_cfg = dataclasses.replace(base, vocab_size=tokenizer.vocab_size)
    enc = build_encoder(bert_cfg, 256 if args.tiny else 65536,
                        compute_dtype(cfg), cfg.train.seed, dev)
    opt = make_optimizer(cfg.optim, enc.encoder_q,
                         convert.bert_entries(bert_cfg.num_layers))

    ds = ContrastiveSubtitleDataset(
        corpus, tokenizer, num_candidates=NUM_CANDIDATES,
        max_text_len=cfg.data.max_text_len, seed=cfg.train.seed)
    loader = DataLoader(ds, cfg.data.batch_size, seed=cfg.train.seed)
    for epoch in range(cfg.train.max_epochs):
        t0 = time.time()
        losses, accs = [], []
        for batch in loader(epoch):
            loss, acc, _ = moco_step(enc, opt, batch,
                                     cfg.optim.grad_norm_clip)
            losses.append(float(loss))
            accs.append(float(acc))
        print(f"epoch {epoch}: loss {np.mean(losses):.4f} "
              f"acc {np.mean(accs):.4f} ({time.time() - t0:.1f}s)",
              flush=True)
    return enc


if __name__ == "__main__":
    main()
