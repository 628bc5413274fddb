"""Evaluate the chapter-title generator (counterpart of the JAX
package's cli/eval_title.py): teacher-forced loss and token accuracy,
KV-cached generation, ROUGE-1/2/L against the ground-truth titles beside
the lead, random and principal baselines, and the reference-layout
result file.

    python -m video_chapter_generation_tpu_torch.cli.eval_title \
        data.data_file=... data.test_vid_file=... train.ckpt_dir=ckpt \
        [--location gt|pred] [--cut_points vid2cut_points.json] \
        [--vision_emb_dir DIR [--fusion_type cross_attn|mlp]] \
        [--num_beams N] [--int8_titles] [--title_arch pegasus|bigbird|bart] \
        [--spm_tsv pieces.tsv] [--tiny] [--device cpu]

Runs on the card unless --device says otherwise. --location gt titles
the ground-truth chapters; --location pred the chapters that
--cut_points (cli/eval_segment's vid2cut_points.json) predicts, the
end-to-end setting. The title model is the best checkpoint of its kind
in train.ckpt_dir (cli/train_title's), else seeded random weights (a
line says which); a corrupt checkpoint raises. --vision_emb_dir (the
output of cli/extract_vision_emb) switches to the vision-conditioned
model: its fused encoder states feed the same decoder. --num_beams N > 1
decodes by beam search, else greedily; --int8_titles serves the
text-only model in weight-only int8 with an int8 cross-attention cache.
The models run in model.compute_dtype. Writes
test_results/chapter_title_gen/[vision_]{location}_batch_{batch}.txt
where it runs.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from typing import Dict, Optional

import numpy as np
import torch

from ..core.checkpoint import CheckpointManager
from ..core.contract import assert_contract, vocab_hash
from ..core.metrics import StepTimer
from ..data.datasets import (
    AllChapterTitleDataset,
    AllChapterTitleVisionEmbDataset,
    npy_vision_emb_provider,
)
from ..data.loader import DataLoader
from ..device import resolve_device
from ..evalkit.title_eval import evaluate_titles, write_title_result_file
from ..models.seq2seq import (
    FUSION_TYPES,
    Seq2Seq,
    Seq2SeqVisionEmb,
    beam_search,
    generate,
    trim_at_eos,
)
from ..ops.quantize import quantize_seq2seq
from ..pipeline.sharded import replicate
from ..train.tasks import TitleGenTask, TitleGenVisionTask, compute_dtype
from .common import (
    load_corpus,
    load_title_tokenizer,
    parse_config,
    pop_flag,
    title_s2s_config,
)

# the ResNet50-TSM embedding width; even the tiny ResNet emits 2048-d
# features (JAX :115, infer_video.py:135)
VISION_EMB_DIM = 2048


def main(argv=None, timer: Optional[StepTimer] = None) -> Dict:
    """Returns the result dict of evaluate_titles, with the generated
    texts under "gen_texts"; `timer` (a StepTimer) receives the
    title_loss (teacher-forced forward) and title_generate stages, items
    counted in chapters (JAX cli/eval_title.py:29-212)."""
    argv = list(argv if argv is not None else sys.argv[1:])
    location = pop_flag(argv, "--location") or "gt"
    cut_points_file = pop_flag(argv, "--cut_points")
    vision_emb_dir = pop_flag(argv, "--vision_emb_dir")
    fusion_type = pop_flag(argv, "--fusion_type") or "cross_attn"
    num_beams = int(pop_flag(argv, "--num_beams") or 1)
    int8_titles = pop_flag(argv, "--int8_titles", value=False) is not None
    if location not in ("gt", "pred"):
        raise SystemExit(f"--location {location}: gt or pred")
    if location == "pred" and not cut_points_file:
        raise SystemExit("--location pred needs --cut_points "
                         "(cli/eval_segment's vid2cut_points.json)")
    if fusion_type not in FUSION_TYPES:
        raise SystemExit(f"--fusion_type {fusion_type}: one of "
                         f"{', '.join(FUSION_TYPES)}")
    vision = vision_emb_dir is not None
    if int8_titles and vision:
        raise SystemExit("--int8_titles supports the text-only title model")

    cfg, args = parse_config(argv, "evaluate chapter-title generator")
    dev = resolve_device(args.device)
    timer = timer or StepTimer()
    corpus = load_corpus(cfg, "test")
    tokenizer = load_title_tokenizer(args, corpus)
    vid2cut_points = None
    if location == "pred":
        with open(cut_points_file) as f:
            vid2cut_points = {vid: v["second_pred_cut_points"]
                              for vid, v in json.load(f).items()}

    s2s_cfg = title_s2s_config(args, tokenizer)
    d = cfg.data
    if vision:
        ds = AllChapterTitleVisionEmbDataset(
            corpus, tokenizer, npy_vision_emb_provider(vision_emb_dir),
            emb_dim=VISION_EMB_DIM, max_text_len=d.title_input_len,
            chapter_title_text_len=d.title_decode_len,
            vid2cut_points=vid2cut_points)
        task = TitleGenVisionTask(cfg, s2s_cfg, fusion_type, VISION_EMB_DIM)
    else:
        ds = AllChapterTitleDataset(corpus, tokenizer, d.title_input_len,
                                    d.title_decode_len,
                                    vid2cut_points=vid2cut_points)
        task = TitleGenTask(cfg, s2s_cfg)
    loader = DataLoader(ds, d.batch_size, shuffle=False, drop_last=False)
    task.contract = dict(task.contract, vocab_hash=vocab_hash(tokenizer))
    model, title_fn = build_title_model(cfg, task, dev, num_beams,
                                        int8_titles)

    losses, accs = [], []
    gen_texts, gt_texts, source_texts = [], [], []
    with torch.no_grad():
        for batch in loader(0):
            n = len(batch["text_ids"])
            timer.start("title_loss")
            _, m = task._metrics(model, batch)
            losses.append(float(m["loss"]))
            accs.append(float(m["acc"]))
            timer.stop("title_loss", n)
            timer.start("title_generate")
            rows = title_fn(batch["text_ids"], batch["attention_mask"], *(
                (batch["vision_embs"], batch["vision_attention_mask"])
                if vision else ()))
            timer.stop("title_generate", n)
            for row, tgt, src, dmask in zip(
                    rows, batch["target_decode_ids"], batch["text_ids"],
                    batch["decode_attention_mask"]):
                gen_texts.append(tokenizer.decode(row))
                gt_texts.append(tokenizer.decode(
                    list(tgt[:int(dmask.sum())])))
                source_texts.append(tokenizer.decode(list(src)))

    result = evaluate_titles(
        gen_texts, gt_texts, source_texts,
        test_loss=float(np.mean(losses)), test_acc=float(np.mean(accs)),
        seed=cfg.train.seed)
    tag = "vision_" if vision else ""
    write_title_result_file(
        result, f"test_results/chapter_title_gen/{tag}{location}_batch_"
                f"{d.batch_size}.txt")
    print("test_loss", result["test_loss"], "test_acc", result["test_acc"])
    for k in ("generated", "lead", "random", "principal"):
        print(k, "rouge-1 f", result[k]["rouge-1"]["f"])
    return dict(result, gen_texts=gen_texts)


def _restore(cfg, task) -> Dict[str, torch.Tensor]:
    """The title model's float32 state dict, for any title family (the
    task's config says which) and for the plain (TitleGenTask, model kind
    "title") and vision-conditioned (TitleGenVisionTask, "title_vision")
    models: the best checkpoint of the task's kind in cfg.train.ckpt_dir
    (cli/train_title writes them), else the task's seeded random weights,
    with a line saying which. Checkpoints of other kinds (the boundary
    model shares the directory in cli/infer_video; a plain title model is
    no vision one) are passed over; a checkpoint without a contract counts
    as a plain title one, as the JAX package's checkpoints may lack it. A
    checkpoint of the task's kind whose contract does not match raises
    ContractMismatch: it never degrades to random weights."""
    ckpt = CheckpointManager(cfg.train.ckpt_dir)
    best = ckpt.best_step()
    if best is None:
        print(f"no checkpoint restored (none in {cfg.train.ckpt_dir}): "
              f"random title weights")
        return task.init_state()
    want = task.contract["model_kind"]
    step = ckpt.best_step(want, default_kind="title")
    if step is None:
        print(f"no checkpoint restored (epoch {best} in "
              f"{cfg.train.ckpt_dir} is a {ckpt.model_kind(best) or 'title'} "
              f"checkpoint, none is a {want} one): random title weights")
        return task.init_state()
    assert_contract(ckpt.metrics_for(step).get("contract") or {},
                    task.contract, context="checkpoint load")
    _, state = ckpt.restore_raw(step)
    print(f"restored checkpoint at epoch {step} (step {state['step']})")
    return state["model"]


def build_title_model(cfg, task, dev: torch.device, num_beams: int = 1,
                      int8_titles: bool = False):
    """The title model of `task` (TitleGenTask or TitleGenVisionTask) as
    this CLI and cli/infer_video serve it: the weights from _restore, with
    int8_titles quantized on dev (weight-only int8, an int8
    cross-attention cache; a fusion head stays float), then on dev in
    model.compute_dtype. The JAX CLIs build the vision path's decoder
    without the task's dtype (this CLI's :133, infer_video.py:164).
    Returns (model, title_fn): title_fn(text_ids, attention_mask,
    *vision_inputs) takes host arrays (the vision model also takes the
    embeddings and their mask, and decodes from its fused encoder states)
    and returns data.title_decode_len ids a row, greedy or with
    num_beams > 1 the best beam, trimmed at EOS (numpy). Its
    replicate(device) gives the same title fn over a copy of the model
    on that device."""
    weights = _restore(cfg, task)
    model = task.model
    vision = isinstance(task, TitleGenVisionTask)
    if int8_titles:  # quantized on the device, where it is quick
        weights = quantize_seq2seq({k: v.to(dev) for k, v in weights.items()})
        s2s_cfg = dataclasses.replace(task.s2s_cfg, weight_quant=True,
                                      kv_quant=True)
        with torch.device("meta"):
            model = (Seq2SeqVisionEmb(s2s_cfg, task.fusion_type,
                                      task.vision_emb_size)
                     if vision else Seq2Seq(s2s_cfg))
    model.load_state_dict(weights, assign=True)
    model.to(dev, compute_dtype(cfg)).eval()
    max_len = cfg.data.title_decode_len

    def decode(s2s, ids, mask, enc_hidden=None):
        if num_beams > 1:
            return beam_search(s2s, ids, mask, num_beams=num_beams,
                               max_len=max_len, enc_hidden=enc_hidden)[0]
        return generate(s2s, ids, mask, max_len=max_len,
                        enc_hidden=enc_hidden)

    def bind(net, on: torch.device):
        def put(a) -> torch.Tensor:
            return torch.from_numpy(np.asarray(a)).to(on)

        def title_fn(text_ids, attention_mask, *vision_inputs):
            ids, mask = put(text_ids).long(), put(attention_mask)
            if vision:  # the fused encode, then the inner Seq2Seq decodes
                vis, vis_mask = map(put, vision_inputs)
                out = decode(net.seq2seq, ids, mask,
                             net.encode_fused(vis, vis_mask, ids, mask))
            else:
                out = decode(net, ids, mask)
            return trim_at_eos(out.cpu().numpy(), task.s2s_cfg.eos_token_id)

        # the same title fn on a replica of the model on another device
        # (pipeline/sharded.py:shard_title_fn)
        title_fn.replicate = lambda d: (
            title_fn if torch.device(d) == on else
            bind(replicate(net, torch.device(d)), torch.device(d)))
        return title_fn

    return model, bind(model, dev)
