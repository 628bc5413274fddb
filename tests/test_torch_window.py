"""The window model (the JAX package's flagship, model.kind
two_stream_window) on the port, against the JAX package on the CPU.

- Each of the five WindowChapterHead types and the base ChapterHead's
  attn head, float32, at 1e-5 absolute and relative (matmuls, LayerNorms
  and softmaxes only); the drawn trees must have the JAX heads' own init
  structure, so models/convert.py's entry tables cover every parameter.
- TwoStreamWindow forward (BERT tiny, ResNet-TSM with stage sizes
  (1, 2, 1, 1), T = 4, 32-px frames, W = 3), float32, at 1e-4 (the vision
  trunk's tolerance, test_torch_models.py).
- A float64 SegmentWindowTask trajectory of three AdamW steps through the
  port's Trainer against the JAX package's optimizer stack with dropout
  off on both sides (JAX deterministic=True, train=True): losses at 1e-9
  relative, parameters and BN statistics at 1e-7 relative plus 1e-10
  absolute (test_torch_train.py reasons the same way).
- cli/train_segment on the default config (--tiny --device cpu): it
  trains the window model with its AUC/mAP eval, build_score_fn restores
  the checkpoint bit for bit and scores InferWindowClipDataset batches,
  a mismatched contract raises, and --init_streams warm-starts from it.
"""

import dataclasses
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
    BertModel as JaxBertModel,
)
from video_chapter_generation_tpu.models.fusion import (
    ChapterHead as JaxChapterHead,
    TwoStreamWindow as JaxTwoStreamWindow,
    WindowChapterHead as JaxWindowChapterHead,
)
from video_chapter_generation_tpu.models.resnet import ResNet as JaxResNet
from video_chapter_generation_tpu.train import optim as jax_optim
from video_chapter_generation_tpu.train.objectives import (
    clip_classification_loss as jax_clip_loss,
)
from video_chapter_generation_tpu_torch.cli import train_segment
from video_chapter_generation_tpu_torch.cli.common import (
    load_bert_tokenizer,
    load_corpus,
    parse_config,
)
from video_chapter_generation_tpu_torch.cli.eval_segment import (
    build_score_fn,
)
from video_chapter_generation_tpu_torch.core.checkpoint import (
    CheckpointManager,
)
from video_chapter_generation_tpu_torch.core.config import Config, OptimConfig
from video_chapter_generation_tpu_torch.core.contract import ContractMismatch
from video_chapter_generation_tpu_torch.data.clip_grid import (
    flatten_video_to_clips,
)
from video_chapter_generation_tpu_torch.data.datasets import (
    InferWindowClipDataset,
)
from video_chapter_generation_tpu_torch.data.synth import (
    make_synth_corpus_on_disk,
)
from video_chapter_generation_tpu_torch.models import convert
from video_chapter_generation_tpu_torch.models.bert import (
    BertConfig,
    BertModel,
)
from video_chapter_generation_tpu_torch.models.fusion import (
    WINDOW_HEAD_TYPES,
    ChapterHead,
    TwoStreamWindow,
    WindowChapterHead,
)
from video_chapter_generation_tpu_torch.models.resnet import ResNet
from video_chapter_generation_tpu_torch.pipeline.boundary import score_clips
from video_chapter_generation_tpu_torch.train.loop import Trainer
from video_chapter_generation_tpu_torch.train.tasks import SegmentWindowTask

W, SEG, H, LANG, VIS, B = 3, 4, 32, 32, 48, 2
T, L, HW = 4, 12, 32
SIZES = (1, 2, 1, 1)
HEAD_TOL = dict(rtol=1e-5, atol=1e-5)
TRUNK_TOL = dict(rtol=1e-4, atol=1e-4)


def _perturb(tree, rng):
    """Norm and BN affines and statistics away from 1 and 0, in place."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _perturb(v, rng)
        elif k in ("scale", "bias", "mean", "var", "bilinear_bias"):
            noise = rng.standard_normal(v.shape).astype(np.float32)
            tree[k] = (np.abs(1 + 0.2 * noise) if k in ("scale", "var")
                       else 0.1 * noise)
    return tree


def _same_structure(tree, jax_variables):
    """The drawn tree has the JAX model's init structure and shapes."""
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jax_variables)
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), tree) == shapes


@pytest.mark.parametrize("head_type", WINDOW_HEAD_TYPES)
def test_window_head_matches_jax(head_type):
    rng = np.random.default_rng(0)
    lang = rng.standard_normal((B, W, LANG)).astype(np.float32)
    vision = rng.standard_normal((B, W, SEG, VIS)).astype(np.float32)
    head = WindowChapterHead(W, SEG, H, head_type, LANG, VIS)
    entries = convert.window_head_entries(head_type)
    tree = _perturb(convert.random_jax_tree(head, entries, seed=1), rng)
    jax_head = JaxWindowChapterHead(W, SEG, H, head_type)
    _same_structure(tree, jax.eval_shape(
        jax_head.init, jax.random.PRNGKey(0), lang, vision)["params"])
    want = jax_head.apply({"params": tree}, lang, vision)
    head.load_state_dict(convert.from_jax(tree, entries))
    got = head.eval()(torch.from_numpy(lang), torch.from_numpy(vision))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **HEAD_TOL)


def test_base_attn_head_matches_jax():
    rng = np.random.default_rng(2)
    lang = rng.standard_normal((B, LANG)).astype(np.float32)
    vision = rng.standard_normal((B, SEG, VIS)).astype(np.float32)
    head = ChapterHead(SEG, H, 2, "attn", LANG, VIS)
    entries = convert.chapter_head_entries("attn")
    tree = convert.random_jax_tree(head, entries, seed=3)
    jax_head = JaxChapterHead(SEG, H, head_type="attn")
    _same_structure(tree, jax.eval_shape(
        jax_head.init, jax.random.PRNGKey(0), lang, vision)["params"])
    want = jax_head.apply({"params": tree}, lang, vision)
    head.load_state_dict(convert.from_jax(tree, entries))
    got = head.eval()(torch.from_numpy(lang), torch.from_numpy(vision))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **HEAD_TOL)


def _no_dropout(cfg):
    return dataclasses.replace(cfg, hidden_dropout=0.0, attention_dropout=0.0)


def _window_tree(seed, stage_sizes=SIZES):
    with torch.device("meta"):
        net = TwoStreamWindow(BertModel(BertConfig.tiny()),
                              ResNet(50, n_segment=T, stage_sizes=stage_sizes),
                              segment_size=T, hidden_size=H)
    entries = convert.two_stream_window_entries(2, stage_sizes)
    return _perturb(convert.random_jax_tree(net, entries, seed=seed),
                    np.random.default_rng(seed))


def _jax_window(stem_input="frames", stage_sizes=SIZES, dtype=jnp.float32):
    return JaxTwoStreamWindow(
        lang_model=JaxBertModel(_no_dropout(JaxBertConfig.tiny()),
                                dtype=dtype),
        vision_model=JaxResNet(stage_sizes=stage_sizes, n_segment=T,
                               stem_input=stem_input, dtype=dtype),
        window_size=1, segment_size=T, hidden_size=H, dtype=dtype)


def _texts(rng):
    ids = rng.integers(1, 128, (B, W, L)).astype(np.int32)
    mask = np.ones((B, W, L), np.int32)
    mask[1, 2, 5:] = 0
    return ids, mask


def test_two_stream_window_matches_jax():
    rng = np.random.default_rng(4)
    tree = _window_tree(5)
    img = rng.standard_normal((B, W, T, HW, HW, 3)).astype(np.float32)
    ids, mask = _texts(rng)
    model = _jax_window()
    _same_structure(tree, jax.eval_shape(
        model.init, jax.random.PRNGKey(0), img, ids, mask))
    logits, probs = jax.jit(model.apply)(tree, img, ids, mask)
    net = TwoStreamWindow(BertModel(BertConfig.tiny()),
                          ResNet(50, n_segment=T, stage_sizes=SIZES),
                          segment_size=T, hidden_size=H).eval()
    net.load_state_dict(convert.from_jax_two_stream_window(tree, 2, SIZES))
    got_logits, got_probs = net(torch.from_numpy(img),
                                torch.from_numpy(ids).long(),
                                torch.from_numpy(mask))
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(logits),
                               **TRUNK_TOL)
    np.testing.assert_allclose(got_probs.numpy(), np.asarray(probs),
                               **TRUNK_TOL)


def test_segment_window_task_trajectory_matches_jax_float64(tmp_path):
    """Three Trainer steps (warmup, then the cosine), float64, s2d frames
    fed already normalized (no float32 normalize rounding enters)."""
    sizes = (1, 1, 1, 1)
    tree = _window_tree(6, sizes)
    rng = np.random.default_rng(7)
    batches = []
    for _ in range(3):
        ids, mask = _texts(rng)
        batches.append({
            "img_clips": rng.standard_normal((B, W, T, 8, 8, 48)),
            "text_ids": ids, "attention_mask": mask,
            "label": np.asarray([0, 1], np.int32)})
    ocfg = dict(learning_rate=1e-3, weight_decay=0.01, grad_norm_clip=1.0,
                warmup_epochs=2, final_epochs=4, lr_decay=True,
                lr_decay_type="cosine")
    jcfg = JaxOptimConfig(**ocfg)
    model = _jax_window("s2d", sizes, jnp.float64)
    jax_losses = []
    with jax.enable_x64(True):
        to64 = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda a: jnp.asarray(a, jnp.float64), t)
        params, bstats = to64(tree["params"]), to64(tree["batch_stats"])
        tx = jax_optim.make_optimizer(jcfg, params)
        opt_state = tx.init(params)

        def loss_fn(p, bs, b):
            (logits, _), mut = model.apply(
                {"params": p, "batch_stats": bs}, b["img_clips"],
                b["text_ids"], b["attention_mask"], deterministic=True,
                train=True, mutable=["batch_stats"])
            return jax_clip_loss(logits, b["label"])[0], mut["batch_stats"]

        @jax.jit
        def step(p, bs, st, b):
            (loss, bs), g = jax.value_and_grad(loss_fn, has_aux=True)(p, bs, b)
            upd, st = tx.update(g, st, p)
            return jax.tree_util.tree_map(lambda a, u: a + u, p, upd), bs, \
                st, loss

        for epoch, batch in enumerate(batches):
            opt_state = jax_optim.set_lr_mult(
                opt_state, jax_optim.lr_multiplier(epoch, jcfg))
            params, bstats, opt_state, loss = step(
                params, bstats, opt_state,
                {k: jnp.asarray(v) for k, v in batch.items()})
            jax_losses.append(float(loss))
        want = {}
        for path, key, kind in convert.two_stream_window_entries(2, sizes):
            leaf = {"params": params, "batch_stats": bstats}
            for p in path:
                leaf = leaf[p]
            want[key] = convert._to_torch_layout(
                np.asarray(leaf, np.float64), kind)

    cfg = Config().apply_overrides(
        [f"data.clip_frame_num={T}", f"model.hidden_size={H}",
         "model.stem_input=s2d", "model.compute_dtype=float64",
         f"train.ckpt_dir={tmp_path / 'ckpt'}",
         f"train.log_dir={tmp_path / 'logs'}", "train.resume=false"])
    cfg = cfg.replace(optim=OptimConfig(**ocfg))
    task = SegmentWindowTask(cfg, tiny=True,
                             bert_cfg=_no_dropout(BertConfig.tiny()),
                             head_dropout=0.0)
    task.init_state = lambda: {
        k: v.double() if v.is_floating_point() else v
        for k, v in convert.from_jax_two_stream_window(tree, 2,
                                                       sizes).items()}
    trainer = Trainer(cfg, task, lambda epoch: [batches[epoch]],
                      device="cpu")
    losses = [trainer.run_epoch(epoch)["loss"] for epoch in range(3)]
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-9)
    got = trainer.model.state_dict()
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-7,
                                   atol=1e-10 + 1e-7 * scale, err_msg=k)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("window_corpus")
    return make_synth_corpus_on_disk(str(root), n_videos=6, video_sec=40,
                                     hw=64, splits={"train": 4, "val": 2})


def _argv(paths, tmp, *extra):
    return [f"data.img_dir={paths['img_dir']}",
            f"data.data_file={paths['data_file']}",
            f"data.subtitle_dir={paths['subtitle_dir']}",
            f"data.train_vid_file={paths['train_vid_file']}",
            f"data.val_vid_file={paths['val_vid_file']}",
            "model.compute_dtype=float32", "data.batch_size=2",
            "data.max_text_len=16", f"data.clip_frame_num={T}",
            "optim.learning_rate=0.01", "optim.lr_decay=false",
            f"train.ckpt_dir={tmp}/ckpt", f"train.log_dir={tmp}/logs",
            *extra, "--tiny", "--device", "cpu"]


def test_train_segment_default_config_trains_and_scores_the_window_model(
        corpus, tmp_path):
    argv = _argv(corpus, tmp_path, "train.max_epochs=1",
                 "train.eval_every_epochs=1")
    trainer = train_segment.main(argv)
    assert isinstance(trainer.model, TwoStreamWindow)
    assert trainer.step == 2
    scalars = [json.loads(line) for line in open(tmp_path / "logs"
                                                 / "scalars.jsonl")]
    tags = {r["tag"]: r["value"] for r in scalars}
    assert np.isfinite(tags["train/loss"]) and "eval/auc" in tags
    ck = CheckpointManager(str(tmp_path / "ckpt"))
    contract = ck.metrics_for(0)["contract"]
    assert contract["model_kind"] == "two_stream_window"
    assert contract["window_size"] == 1

    # the scorer restores the checkpoint bit for bit and scores windows
    cfg, args = parse_config(argv)
    train = load_corpus(cfg, "train")
    tok = load_bert_tokenizer(args, train)
    score = build_score_fn(cfg, args, tok, device="cpu")
    trained = trainer.model.state_dict()
    for k, v in score.model.state_dict().items():
        assert torch.equal(v, trained[k]), k
    vid = train.vids[0]
    clips = flatten_video_to_clips(vid, train.img_dir, train.image_num(vid),
                                   train.raw_cut_secs(vid),
                                   train.subtitles(vid), T)
    ds = InferWindowClipDataset(clips, tok, T, 16, window_size=1, hw=64)
    assert ds[0]["img_clips"].shape == (3, T, 64, 64, 3)
    infos = score_clips(ds, score, batch_size=4)
    probs = np.asarray([c.pred_score for c in infos])
    assert len(probs) == len(clips)
    assert np.isfinite(probs).all() and (probs >= 0).all() and \
        (probs <= 1).all()
    with pytest.raises(ContractMismatch, match="window_size"):
        build_score_fn(cfg.apply_overrides(["data.window_size=2"]), args,
                       tok, device="cpu")

    # warm start of a window model from the window checkpoint
    warm = train_segment.main(_argv(corpus, tmp_path / "warm",
                                    "train.max_epochs=0") + [
        "--init_streams", str(tmp_path / "ckpt")])
    got = warm.model.state_dict()
    for k, v in trained.items():
        if k.startswith(("lang_model.", "vision_model.")):
            assert torch.equal(got[k], v.cpu()), k
