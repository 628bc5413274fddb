"""The text-only boundary model (model.kind=text) on the port against the
JAX package, on the CPU.

- BertForChapter with the chapter head and with the bias-free MLM head
  against the JAX module (float32, 1e-5 of the largest logit).
- Three Trainer steps of SegmentTextTask in float64 (dropout off)
  against the JAX optimizer stack: losses at 1e-9 relative, every
  parameter at 1e-7 relative.
- cli/train_segment, cli/eval_segment.build_score_fn and cli/infer_video
  with model.kind=text, tiny, end to end (the JAX package's
  tests/test_cli.py:80, 100-135 runs the same three).
"""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from video_chapter_generation_tpu.core.config import (
    OptimConfig as JaxOptimConfig,
)
from video_chapter_generation_tpu.models.bert import (
    BertConfig as JaxBertConfig,
    BertForChapter as JaxBertForChapter,
)
from video_chapter_generation_tpu.train import optim as jax_optim
from video_chapter_generation_tpu.train.objectives import (
    clip_classification_loss as jax_clip_loss,
)
from video_chapter_generation_tpu_torch.cli import (
    eval_segment,
    infer_video,
    train_segment,
)
from video_chapter_generation_tpu_torch.cli.common import parse_config
from video_chapter_generation_tpu_torch.core.checkpoint import (
    CheckpointManager,
)
from video_chapter_generation_tpu_torch.core.config import Config, OptimConfig
from video_chapter_generation_tpu_torch.data.corpus import VideoCorpus
from video_chapter_generation_tpu_torch.data.datasets import InferClipDataset
from video_chapter_generation_tpu_torch.data.clip_grid import (
    flatten_video_to_clips,
)
from video_chapter_generation_tpu_torch.data.loader import collate
from video_chapter_generation_tpu_torch.data.synth import (
    make_synth_corpus_on_disk,
)
from video_chapter_generation_tpu_torch.data.tokenization import (
    WordPieceTokenizer,
)
from video_chapter_generation_tpu_torch.models import convert
from video_chapter_generation_tpu_torch.models.bert import (
    BertConfig,
    BertForChapter,
)
from video_chapter_generation_tpu_torch.train.loop import Trainer
from video_chapter_generation_tpu_torch.train.tasks import SegmentTextTask

VOCAB, B, L = 64, 3, 12


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _no_dropout(cfg):
    import dataclasses

    return dataclasses.replace(cfg, hidden_dropout=0.0,
                               attention_dropout=0.0)


def _tree(seed, pretrain):
    with torch.device("meta"):
        net = BertForChapter(BertConfig.tiny(VOCAB), pretrain)
    entries = convert.bert_for_chapter_entries(2, pretrain)
    tree = convert.random_jax_tree(net, entries, seed=seed)
    rng = np.random.default_rng(seed)
    head = tree["params"]["head"]
    if "bias" in head:
        head["bias"] = rng.standard_normal(2).astype(np.float32)
    return tree, entries


def _batch(rng):
    ids = rng.integers(1, VOCAB, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, L - 4:] = 0
    ids[mask == 0] = 0
    return {"text_ids": ids, "attention_mask": mask,
            "label": np.asarray([0, 1, 1], np.int32)}


@pytest.mark.parametrize("pretrain", [False, True])
def test_bert_for_chapter_matches_jax(pretrain):
    tree, entries = _tree(3, pretrain)
    b = _batch(np.random.default_rng(4))
    jmodel = JaxBertForChapter(JaxBertConfig.tiny(VOCAB),
                               pretrain_stage=pretrain)
    jl, jp = jmodel.apply(tree, b["text_ids"], b["attention_mask"])
    with torch.device("meta"):
        net = BertForChapter(BertConfig.tiny(VOCAB), pretrain)
    net.load_state_dict(convert.from_jax(tree, entries), assign=True)
    logits, probs = net.eval()(torch.from_numpy(b["text_ids"]).long(),
                               torch.from_numpy(b["attention_mask"]))
    want = np.asarray(jl)
    assert logits.shape == ((B, L, VOCAB) if pretrain else (B, 2))
    assert "head.bias" not in net.state_dict() or not pretrain
    np.testing.assert_allclose(logits.detach().numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(probs.detach().numpy(), np.asarray(jp),
                               rtol=0, atol=1e-5)


def test_segment_text_trajectory_matches_jax_float64(tmp_path):
    tree, entries = _tree(5, False)
    rng = np.random.default_rng(6)
    batches = [_batch(rng) for _ in range(3)]
    ocfg = dict(learning_rate=1e-3, weight_decay=0.01, grad_norm_clip=0.5,
                warmup_epochs=2, final_epochs=4, lr_decay=True,
                lr_decay_type="cosine")
    model = JaxBertForChapter(_no_dropout(JaxBertConfig.tiny(VOCAB)),
                              dtype=jnp.float64)
    jax_losses = []
    with jax.enable_x64(True):
        params = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), tree["params"])
        joc = JaxOptimConfig(**ocfg)
        tx = jax_optim.make_optimizer(joc, params)
        state = tx.init(params)

        def loss_fn(p, b):
            logits, _ = model.apply({"params": p}, b["text_ids"],
                                    b["attention_mask"])
            return jax_clip_loss(logits, b["label"])[0]

        @jax.jit
        def step(p, st, b):
            loss, g = jax.value_and_grad(loss_fn)(p, b)
            upd, st = tx.update(g, st, p)
            return jax.tree_util.tree_map(lambda a, u: a + u, p, upd), st, \
                loss

        for epoch, batch in enumerate(batches):
            state = jax_optim.set_lr_mult(
                state, jax_optim.lr_multiplier(epoch, joc))
            params, state, loss = step(
                params, state, {k: jnp.asarray(v) for k, v in batch.items()})
            jax_losses.append(float(loss))
        final = {"params": jax.tree_util.tree_map(np.asarray, params)}
        want = {key: convert._to_torch_layout(
            np.asarray(convert._get(final, path), np.float64), kind)
            for path, key, kind in entries}

    cfg = Config().apply_overrides([
        "model.compute_dtype=float64", "train.resume=false",
        f"data.max_text_len={L}", f"train.ckpt_dir={tmp_path / 'ckpt'}",
        f"train.log_dir={tmp_path / 'logs'}"])
    cfg = cfg.replace(optim=OptimConfig(**ocfg))
    task = SegmentTextTask(cfg, bert_cfg=_no_dropout(BertConfig.tiny(VOCAB)))
    assert task.contract["model_kind"] == "text"
    init = convert.from_jax(tree, entries)
    task.init_state = lambda: {k: v.double() for k, v in init.items()}
    trainer = Trainer(cfg, task, lambda epoch: [batches[epoch]],
                      device="cpu")
    losses = [trainer.run_epoch(epoch)["loss"] for epoch in range(3)]
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-9)
    got = trainer.model.state_dict()
    # atol floor: the attention key biases get exactly zero gradient in
    # exact arithmetic (softmax ignores a per-query constant), so both
    # sides hold rounding noise there
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-7,
                                   atol=1e-10 + 1e-7 * np.abs(w).max(),
                                   err_msg=k)
    assert any(not torch.equal(got[k].float(), init[k]) for k in init)


@pytest.fixture(scope="module")
def text_corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("text_corpus")
    paths = make_synth_corpus_on_disk(str(root), n_videos=7, video_sec=40,
                                      hw=64, splits={"train": 4, "val": 2,
                                                     "test": 1})
    corpus = VideoCorpus.from_files(paths["img_dir"], paths["data_file"],
                                    paths["train_vid_file"],
                                    paths["subtitle_dir"])
    tok = WordPieceTokenizer.build_from_corpus(
        [s["text"] for vid in corpus.vids for s in corpus.subtitles(vid)],
        vocab_size=300)
    vocab = root / "vocab.txt"
    vocab.write_text("\n".join(sorted(tok.vocab, key=tok.vocab.get)) + "\n")
    return paths, str(vocab)


def _argv(paths, tmp, vocab, *extra):
    return [f"data.img_dir={paths['img_dir']}",
            f"data.data_file={paths['data_file']}",
            f"data.subtitle_dir={paths['subtitle_dir']}",
            f"data.train_vid_file={paths['train_vid_file']}",
            f"data.val_vid_file={paths['val_vid_file']}",
            f"data.test_vid_file={paths['test_vid_file']}",
            "model.kind=text", "model.compute_dtype=float32",
            "data.batch_size=2", "data.max_text_len=16",
            "data.clip_frame_num=4", "data.title_input_len=24",
            "data.title_decode_len=6", "optim.learning_rate=0.01",
            "optim.lr_decay=false", "train.max_epochs=2",
            "train.eval_every_epochs=1", "train.resume=false",
            f"train.ckpt_dir={tmp}/ckpt", f"train.log_dir={tmp}/logs",
            *extra, "--bert_vocab", vocab, "--tiny", "--device", "cpu"]


def test_text_model_train_eval_infer_cli(text_corpus, tmp_path, capsys,
                                         monkeypatch):
    paths, vocab = text_corpus
    trainer = train_segment.main(_argv(paths, tmp_path, vocab))
    assert isinstance(trainer.model, BertForChapter)
    assert trainer.step == 4
    ck = CheckpointManager(str(tmp_path / "ckpt"))
    assert ck.steps() == [0, 1] and ck.model_kind(1) == "text"
    assert 0.0 <= ck.metrics_for(1)["score"] <= 1.0  # mAP
    losses = [r["value"] for r in map(
        json.loads, open(tmp_path / "logs" / "scalars.jsonl"))
        if r["tag"] == "train/loss"]
    assert len(losses) == 2 and np.isfinite(losses).all()

    # the scorer: the checkpoint, probabilities over InferClipDataset
    cfg, args = parse_config(_argv(paths, tmp_path, vocab))
    tok = WordPieceTokenizer.from_vocab_file(vocab)
    capsys.readouterr()
    score = eval_segment.build_score_fn(cfg, args, tok, device="cpu")
    assert "restored checkpoint at epoch" in capsys.readouterr().out
    test = VideoCorpus.from_files(paths["img_dir"], paths["data_file"],
                                  paths["test_vid_file"],
                                  paths["subtitle_dir"])
    vid = test.vids[0]
    clips = flatten_video_to_clips(vid, test.img_dir, test.image_num(vid),
                                   test.raw_cut_secs(vid),
                                   test.subtitles(vid), 4)
    ds = InferClipDataset(clips, tok, 16, mode="text")
    probs = np.asarray(score(collate([ds[i] for i in range(4)])))
    assert probs.shape == (4,) and ((probs >= 0) & (probs <= 1)).all()
    with pytest.raises(SystemExit, match="two-stream"):
        eval_segment.build_score_fn(cfg, args, tok, device="cpu",
                                    calib_clips=np.zeros(1))

    monkeypatch.chdir(tmp_path)
    results = infer_video.main(_argv(paths, tmp_path, vocab))
    out = capsys.readouterr().out
    assert "restored checkpoint at epoch" in out
    (vid, r), = results.items()
    assert len(r.clip_scores) > 0 and len(r.titles) == len(r.cut_points)
    assert (tmp_path / "test_results" / "whole_pipeline_result.txt").exists()
    with pytest.raises(SystemExit, match="two_stream"):
        infer_video.main(_argv(paths, tmp_path, vocab) + ["--int8_vision"])
