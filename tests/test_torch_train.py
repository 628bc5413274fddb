"""The port's training slice against the JAX package, on the CPU.

- SegmentTask.loss_fn (JAX, dropout off) vs the port's TwoStream training
  forward and loss gradient, in float64: the loss at 1e-10, every
  parameter gradient at 1e-7 of its largest magnitude (1e-12 absolute
  floor), BN running statistics after the step at 1e-10 (a tiny model:
  BERT tiny, ResNet-TSM with one block per stage on 64-px s2d frames,
  fed already normalized so that no float32 normalize rounding enters;
  in float32 the JAX package's XLA convolutions on the CPU differ from
  float64 by ~1e-2 of a gradient's largest magnitude, see
  tests/test_tsm_block_train_pallas.py:290-294).
- Three AdamW steps in float64 with the warmup/cosine schedule, the
  global-norm clip and the decay partition, on the same batches: losses
  at 1e-9 relative, every parameter and BN statistic at 1e-7 relative
  plus 1e-10 absolute (float64 makes the trajectory deterministic to
  rounding; test_train_parity.py reasons the same way).
- The optimizer recipe's pieces (decay mask, LR multiplier), dropout
  driven by an explicit generator, checkpoints, the folded inference
  weights after a parameter update, and cli/train_segment --tiny
  end to end (train, checkpoint, resume, warm start, eval).
"""

import dataclasses
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import video_chapter_generation_tpu.models.resnet as jax_resnet
from video_chapter_generation_tpu.core.config import (
    Config as JaxConfig,
    OptimConfig as JaxOptimConfig,
)
from video_chapter_generation_tpu.models.bert import (
    BertConfig as JaxBertConfig,
    BertModel as JaxBertModel,
)
from video_chapter_generation_tpu.models.fusion import TwoStream as JaxTwoStream
from video_chapter_generation_tpu.train import optim as jax_optim
from video_chapter_generation_tpu.train.objectives import (
    clip_classification_loss as jax_clip_loss,
)
from video_chapter_generation_tpu.train.tasks import (
    SegmentTask as JaxSegmentTask,
)
from video_chapter_generation_tpu_torch.cli import train_segment
from video_chapter_generation_tpu_torch.core.checkpoint import (
    CheckpointManager,
)
from video_chapter_generation_tpu_torch.core.config import Config, OptimConfig
from video_chapter_generation_tpu_torch.data.synth import (
    make_synth_corpus_on_disk,
)
from video_chapter_generation_tpu_torch.models import convert
from video_chapter_generation_tpu_torch.models.bert import (
    BertConfig,
    BertModel,
)
from video_chapter_generation_tpu_torch.models.fusion import TwoStream
from video_chapter_generation_tpu_torch.models.resnet import ResNet
from video_chapter_generation_tpu_torch.train import optim
from video_chapter_generation_tpu_torch.train.loop import Trainer
from video_chapter_generation_tpu_torch.train.tasks import SegmentTask

T, B, L, HIDDEN = 4, 2, 12, 16
SIZES = (1, 1, 1, 1)


def _no_dropout(cfg):
    return dataclasses.replace(cfg, hidden_dropout=0.0, attention_dropout=0.0)


def _batch(rng):
    """Float s2d frames (already normalized: both sides skip the uint8
    normalize, whose rounding XLA and torch do differently in float32)."""
    return {
        "img_clip": rng.standard_normal((B, T, 16, 16, 48)),
        "text_ids": rng.integers(1, 128, (B, L)).astype(np.int32),
        "attention_mask": np.concatenate(
            [np.ones((B, L - 3), np.int32),
             np.asarray([[1] * 3, [0] * 3], np.int32)], axis=1),
        "label": np.asarray([0, 1], np.int32),
    }


def _tree(seed):
    """A seeded tiny TwoStream tree in the JAX layout, BN statistics and
    affines perturbed so running-average updates and BN scales show."""
    with torch.device("meta"):
        net = TwoStream(BertModel(BertConfig.tiny()),
                        ResNet(50, n_segment=T, stem_input="s2d",
                               stage_sizes=SIZES),
                        segment_size=T, hidden_size=HIDDEN)
    tree = convert.random_jax_tree(net, convert.two_stream_entries(2, SIZES),
                                   seed=seed)
    rng = np.random.default_rng(seed)

    def walk(node):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v)
            elif k in ("scale", "var", "mean") or (k == "bias" and v.ndim):
                noise = rng.standard_normal(v.shape).astype(np.float32)
                node[k] = (np.abs(1 + 0.2 * noise) if k in ("scale", "var")
                           else 0.1 * noise)
    walk(tree)
    return tree


def _port_model(tree, dtype=torch.float32):
    net = TwoStream(BertModel(_no_dropout(BertConfig.tiny())),
                    ResNet(50, n_segment=T, stem_input="s2d",
                           stage_sizes=SIZES, dtype=dtype),
                    segment_size=T, hidden_size=HIDDEN, dtype=dtype)
    net.load_state_dict(convert.from_jax_two_stream(tree, 2, SIZES))
    return net.to(dtype).train()


def _jax_model(dtype=jnp.float32):
    return JaxTwoStream(
        lang_model=JaxBertModel(_no_dropout(JaxBertConfig.tiny()),
                                dtype=dtype),
        vision_model=jax_resnet.ResNet(stage_sizes=SIZES, n_segment=T,
                                       stem_input="s2d", dtype=dtype),
        segment_size=T, hidden_size=HIDDEN, head_type="mlp", dtype=dtype)


def _as_port(tree):
    """A {params, batch_stats}-shaped JAX tree -> port state dict, in
    float64 (models/convert.py's entry table, without its float32 cast)."""
    out = {}
    for path, key, kind in convert.two_stream_entries(2, SIZES):
        leaf = tree
        for p in path:
            leaf = leaf[p]
        out[key] = torch.from_numpy(np.array(convert._to_torch_layout(
            np.asarray(leaf, np.float64), kind)))
    return out


def _assert_close_rel(got, want, rel, atol=0.0, names=None):
    for k in want:
        w = np.asarray(want[k], np.float64)
        g = got[k].detach().double().numpy()
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=rel, atol=atol + rel * scale,
                                   err_msg=k)


def _to64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


def test_two_stream_training_step_matches_segment_task():
    tree = _tree(31)
    batch = _batch(np.random.default_rng(32))
    cfg = JaxConfig().apply_overrides([f"data.clip_frame_num={T}",
                                       f"model.hidden_size={HIDDEN}",
                                       "model.stem_input=s2d",
                                       "model.compute_dtype=float32"])
    task = JaxSegmentTask(cfg, tiny=True)
    with jax.enable_x64(True):
        task.model = _jax_model(jnp.float64)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        (loss_ref, (metrics, new_bs)), grads = jax.jit(jax.value_and_grad(
            task.loss_fn, has_aux=True))(
                _to64(tree["params"]), _to64(tree["batch_stats"]), jb,
                jax.random.PRNGKey(0))
        want = _as_port({"params": grads, "batch_stats": new_bs})

    net = _port_model(tree, torch.float64)
    task_port = SegmentTask(Config().apply_overrides(
        [f"data.clip_frame_num={T}", f"model.hidden_size={HIDDEN}",
         "model.stem_input=s2d", "model.compute_dtype=float64"]),
        tiny=True, bert_cfg=_no_dropout(BertConfig.tiny()))
    loss, port_metrics = task_port.loss_fn(net, batch)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_ref),
                               rtol=1e-10)
    assert float(port_metrics["acc"]) == float(metrics["acc"])
    params = dict(net.named_parameters())
    # atol floor: the attention key biases get exactly zero gradient in
    # exact arithmetic (softmax ignores a per-query constant), so both
    # sides hold rounding noise there
    _assert_close_rel({k: params[k].grad for k in params},
                      {k: want[k] for k in params}, 1e-7, atol=1e-12)
    bufs = {k: v for k, v in net.state_dict().items() if "running" in k}
    _assert_close_rel(bufs, {k: want[k] for k in bufs}, 1e-10)


def test_trainer_trajectory_matches_jax_float64(tmp_path):
    """Three Trainer steps (one per epoch: warmup 0.01 -> 0.5, then the
    cosine) against the JAX package's optimizer stack, float64."""
    tree = _tree(41)
    rng = np.random.default_rng(42)
    batches = [_batch(rng) for _ in range(3)]
    ocfg = dict(learning_rate=1e-3, weight_decay=0.01, grad_norm_clip=1.0,
                warmup_epochs=2, final_epochs=4, lr_decay=True,
                lr_decay_type="cosine")

    # JAX package: make_optimizer + set_lr_mult, float64
    jcfg = JaxOptimConfig(**ocfg)
    model = _jax_model(jnp.float64)
    jax_losses = []
    with jax.enable_x64(True):
        to64 = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda a: jnp.asarray(a, jnp.float64), t)
        params, bstats = to64(tree["params"]), to64(tree["batch_stats"])
        tx = jax_optim.make_optimizer(jcfg, params)
        opt_state = tx.init(params)

        def loss_fn(p, bs, b):
            (logits, _), mut = model.apply(
                {"params": p, "batch_stats": bs}, b["img_clip"],
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
            jb = {k: jnp.asarray(v) for k, v in batch.items()}
            params, bstats, opt_state, loss = step(params, bstats, opt_state,
                                                   jb)
            jax_losses.append(float(loss))
        want = _as_port({"params": params, "batch_stats": bstats})

    # the port: the Trainer with SegmentTask, float64, one batch per epoch
    cfg = Config().apply_overrides(
        [f"data.clip_frame_num={T}", f"model.hidden_size={HIDDEN}",
         "model.stem_input=s2d", "model.compute_dtype=float64",
         f"train.ckpt_dir={tmp_path / 'ckpt'}",
         f"train.log_dir={tmp_path / 'logs'}", "train.resume=false"])
    cfg = cfg.replace(optim=OptimConfig(**ocfg))
    task = SegmentTask(cfg, tiny=True, bert_cfg=_no_dropout(BertConfig.tiny()))
    task.init_state = lambda: {
        k: v.double() if v.is_floating_point() else v
        for k, v in convert.from_jax_two_stream(tree, 2, SIZES).items()}
    trainer = Trainer(cfg, task, lambda epoch: [batches[epoch]],
                      device="cpu")
    losses = [trainer.run_epoch(epoch)["loss"] for epoch in range(3)]
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-9)
    got = trainer.model.state_dict()
    _assert_close_rel({k: got[k] for k in want
                       if not k.endswith("num_batches_tracked")},
                      {k: v for k, v in want.items()
                       if not k.endswith("num_batches_tracked")},
                      1e-7, atol=1e-10)


def test_decay_mask_and_schedule_match_jax():
    tree = _tree(51)
    net = _port_model(tree)
    mask = optim.no_decay_mask(net, convert.two_stream_entries(2, SIZES))
    jmask = jax_optim.no_decay_mask(tree["params"])
    want = convert.from_jax_two_stream(
        {"params": jax.tree_util.tree_map(
            lambda m, p: np.full(p.shape, m, np.float32), jmask,
            tree["params"]),
         "batch_stats": tree["batch_stats"]}, 2, SIZES)
    assert mask == {k: bool(want[k].flatten()[0]) for k in mask}
    assert any(mask.values()) and not all(mask.values())
    for kw in (dict(), dict(lr_decay_type="exp"), dict(lr_decay=False)):
        jc, pc = JaxOptimConfig(final_epochs=10, **kw), OptimConfig(
            final_epochs=10, **kw)
        for epoch in range(12):
            assert optim.lr_multiplier(epoch, pc) == \
                jax_optim.lr_multiplier(epoch, jc)
    with pytest.raises(NotImplementedError):
        optim.make_optimizer(OptimConfig(gradient_accumulation_steps=2), net,
                             convert.two_stream_entries(2, SIZES))


def test_bert_dropout_follows_its_generator():
    bert = BertModel(BertConfig.tiny()).train()
    ids = torch.randint(1, 128, (2, 8), generator=torch.Generator()
                        .manual_seed(0))
    mask = torch.ones_like(ids)
    run = lambda seed: bert(ids, mask, generator=torch.Generator()  # noqa: E731
                            .manual_seed(seed))[0]
    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))
    bert.eval()
    assert torch.equal(run(1), run(2))


def test_checkpoint_manager_keeps_the_newest(tmp_path):
    ck = CheckpointManager(str(tmp_path), max_to_keep=2)
    assert ck.restore_latest() is None
    for epoch in range(3):
        ck.save(epoch, {"model": {"w": torch.full((2,), float(epoch))},
                        "step": epoch}, score=0.5 * epoch,
                metrics={"contract": {"frame_hw": 64}})
    assert ck.steps() == [1, 2]
    epoch, state = ck.restore_latest()
    assert epoch == 2 and torch.equal(state["model"]["w"], torch.full((2,), 2.))
    assert ck.restore_raw(1)[1]["step"] == 1
    assert ck.metrics_for(2) == {"score": 1.0, "contract": {"frame_hw": 64}}


def test_folded_weights_follow_parameter_updates():
    """An optimizer step changes parameters in place; the next eval must
    fold the new weights, not serve the cached ones."""
    tree = _tree(61)
    net = ResNet(50, n_segment=T, stem_input="s2d", stage_sizes=SIZES).eval()
    net.load_state_dict(convert.from_jax_resnet(
        {"params": tree["params"]["vision_model"],
         "batch_stats": tree["batch_stats"]["vision_model"]}, SIZES))
    x = torch.from_numpy(np.random.default_rng(62).integers(
        0, 256, (T, 16, 16, 48), np.uint8))
    before = net(x)
    with torch.no_grad():
        for p in net.parameters():
            p.mul_(1.5)
    after = net(x)
    fresh = ResNet(50, n_segment=T, stem_input="s2d",
                   stage_sizes=SIZES).eval()
    fresh.load_state_dict(net.state_dict())
    assert not torch.allclose(before, after)
    assert torch.equal(after, fresh(x))
    # a training forward moves the running statistics: eval refolds too
    net.train()(x)
    fresh.load_state_dict(net.state_dict())
    assert torch.equal(net.eval()(x), fresh(x))


@pytest.fixture(scope="module")
def tiny_corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    return make_synth_corpus_on_disk(str(root), n_videos=6, video_sec=40,
                                     hw=64, splits={"train": 4, "val": 2})


def _argv(paths, tmp, *extra):
    return [f"data.img_dir={paths['img_dir']}",
            f"data.data_file={paths['data_file']}",
            f"data.subtitle_dir={paths['subtitle_dir']}",
            f"data.train_vid_file={paths['train_vid_file']}",
            f"data.val_vid_file={paths['val_vid_file']}",
            "model.kind=two_stream", "model.stem_input=s2d",
            "model.compute_dtype=float32", "data.batch_size=2",
            "optim.learning_rate=0.01", "optim.lr_decay=false",
            "data.max_text_len=16", "data.clip_frame_num=4",
            f"train.ckpt_dir={tmp}/ckpt", f"train.log_dir={tmp}/logs",
            *extra, "--tiny", "--device", "cpu"]


def test_train_segment_cli_tiny(tiny_corpus, tmp_path):
    first = train_segment.main(_argv(tiny_corpus, tmp_path,
                                     "train.max_epochs=1"))
    assert first.step == 2 and CheckpointManager(
        str(tmp_path / "ckpt")).steps() == [0]
    losses = [json.loads(line) for line in open(tmp_path / "logs"
                                                / "scalars.jsonl")]
    assert np.isfinite([r["value"] for r in losses
                        if r["tag"] == "train/loss"]).all()
    # resume: epoch 0 is restored, epoch 1 trains and saves
    second = train_segment.main(_argv(tiny_corpus, tmp_path,
                                      "train.max_epochs=2"))
    assert second.start_epoch == 1 and second.step == 4
    ck = CheckpointManager(str(tmp_path / "ckpt"))
    assert ck.steps() == [0, 1]
    assert ck.metrics_for(1)["contract"]["model_kind"] == "two_stream"
    # eval after training serves the trained weights, folded afresh after
    # the optimizer's in-place updates (the CLI runs with a learning rate
    # large enough that stale folded weights would show)
    net = second.model.eval()
    fresh = TwoStream(BertModel(net.lang_model.cfg),
                      ResNet(50, n_segment=4, stem_input="s2d",
                             stage_sizes=SIZES),
                      segment_size=4,
                      hidden_size=second.cfg.model.hidden_size)
    fresh.load_state_dict(ck.restore_latest()[1]["model"])
    fresh.eval()
    rng = np.random.default_rng(71)
    img = torch.from_numpy(rng.integers(0, 256, (2, 4, 16, 16, 48),
                                        np.uint8))
    ids = torch.from_numpy(rng.integers(1, net.lang_model.cfg.vocab_size,
                                        (2, 16)))
    mask = torch.ones_like(ids)
    init = TwoStream(BertModel(net.lang_model.cfg),
                     ResNet(50, n_segment=4, stem_input="s2d",
                            stage_sizes=SIZES),
                     segment_size=4, hidden_size=second.cfg.model.hidden_size)
    init.load_state_dict(second.task.init_state())
    got, want = net(img, ids, mask)[0], fresh(img, ids, mask)[0]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert (got - init.eval()(img, ids, mask)[0]).abs().max() > 1e-2
    # warm start: the streams come from the checkpoint, the head does not
    warm = train_segment.main(_argv(tiny_corpus, tmp_path / "warm",
                                    "train.max_epochs=0") + [
        "--init_streams", str(tmp_path / "ckpt")])
    saved = ck.restore_latest()[1]["model"]
    got = warm.model.state_dict()
    for k in saved:
        if k.startswith(("lang_model.", "vision_model.")):
            assert torch.equal(got[k], saved[k]), k
    assert not torch.equal(got["fusion_head.head.weight"],
                           saved["fusion_head.head.weight"])


@pytest.mark.parametrize("kind", ["two_stream_window", "text"])
def test_train_segment_names_what_is_not_ported(tiny_corpus, tmp_path, kind):
    with pytest.raises(SystemExit, match="ROADMAP queue 1"):
        train_segment.main(_argv(tiny_corpus, tmp_path,
                                 f"model.kind={kind}"))
