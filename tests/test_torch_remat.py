"""model.remat_vision on the port (the JAX package's nn.remat of every
vision bottleneck, models/resnet.py:747-749), on the CPU.

- cli/train_segment trains the window model (the default model.kind)
  with model.remat_vision=true in float64 and ends exactly where the same
  run with remat off ends: the same losses, every parameter and every BN
  statistic equal. Rematerializing computes the same function again, and
  the running averages move once a step, from the first forward.
- A float64 SegmentWindowTask trajectory of three AdamW steps with remat
  on, through the port's Trainer, against the JAX package's
  remat_vision=True run, at test_torch_window.py's tolerances: losses at
  1e-9 relative, parameters and BN statistics at 1e-7 relative plus
  1e-10 absolute. (Under "auto" the JAX package trains the remat route
  through its 3-tap conv1 and the port through the K12 block; on the CPU
  both are plain versions of the same function.)
"""

import json

import numpy as np

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
    TwoStreamWindow as JaxTwoStreamWindow,
)
from video_chapter_generation_tpu.models.resnet import ResNet as JaxResNet
from video_chapter_generation_tpu.train import optim as jax_optim
from video_chapter_generation_tpu.train.objectives import (
    clip_classification_loss as jax_clip_loss,
)
from video_chapter_generation_tpu_torch.cli import train_segment
from video_chapter_generation_tpu_torch.core.config import Config, OptimConfig
from video_chapter_generation_tpu_torch.data.synth import (
    make_synth_corpus_on_disk,
)
from video_chapter_generation_tpu_torch.models import convert
from video_chapter_generation_tpu_torch.models.bert import BertConfig
from video_chapter_generation_tpu_torch.train.loop import Trainer
from video_chapter_generation_tpu_torch.train.tasks import SegmentWindowTask

from test_torch_window import B, H, T, W, _no_dropout, _texts, _window_tree


def test_train_segment_remat_equals_no_remat_float64(tmp_path):
    paths = make_synth_corpus_on_disk(str(tmp_path / "corpus"), n_videos=4,
                                      video_sec=40, hw=64,
                                      splits={"train": 3, "val": 1})

    def run(remat):
        out = tmp_path / f"remat_{remat}"
        trainer = train_segment.main([
            f"data.img_dir={paths['img_dir']}",
            f"data.data_file={paths['data_file']}",
            f"data.subtitle_dir={paths['subtitle_dir']}",
            f"data.train_vid_file={paths['train_vid_file']}",
            f"data.val_vid_file={paths['val_vid_file']}",
            "model.compute_dtype=float64", "data.batch_size=2",
            "data.max_text_len=16", f"data.clip_frame_num={T}",
            "optim.learning_rate=0.01", "optim.lr_decay=false",
            "train.max_epochs=2", f"model.remat_vision={remat}",
            f"train.ckpt_dir={out}/ckpt", f"train.log_dir={out}/logs",
            "--tiny", "--device", "cpu"])
        losses = [r["value"] for r in map(json.loads,
                                          open(out / "logs" / "scalars.jsonl"))
                  if r["tag"] == "train/loss"]
        return trainer, losses

    on, losses_on = run("true")
    off, losses_off = run("false")
    assert on.model.vision_model.remat and not off.model.vision_model.remat
    assert on.step == off.step >= 2
    assert losses_on == losses_off and np.isfinite(losses_on).all()
    got, want = on.model.state_dict(), off.model.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    init = on.task.init_state()
    assert any(not torch.equal(init[k], got[k]) for k in got
               if k.startswith("vision_model.") and "running" in k)


def test_remat_trajectory_matches_jax_float64(tmp_path):
    sizes = (1, 1, 1, 1)
    tree = _window_tree(6, sizes)
    rng = np.random.default_rng(9)
    batches = []
    for _ in range(3):
        ids, mask = _texts(rng)
        batches.append({
            "img_clips": rng.standard_normal((B, W, T, 8, 8, 48)),
            "text_ids": ids, "attention_mask": mask,
            "label": np.asarray([1, 0], np.int32)})
    ocfg = dict(learning_rate=1e-3, weight_decay=0.01, grad_norm_clip=1.0,
                warmup_epochs=2, final_epochs=4, lr_decay=True,
                lr_decay_type="cosine")
    jcfg = JaxOptimConfig(**ocfg)
    model = JaxTwoStreamWindow(
        lang_model=JaxBertModel(_no_dropout(JaxBertConfig.tiny()),
                                dtype=jnp.float64),
        vision_model=JaxResNet(stage_sizes=sizes, n_segment=T,
                               stem_input="s2d", dtype=jnp.float64,
                               remat=True),
        window_size=1, segment_size=T, hidden_size=H, dtype=jnp.float64)
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
         "model.remat_vision=true",
         f"train.ckpt_dir={tmp_path / 'ckpt'}",
         f"train.log_dir={tmp_path / 'logs'}", "train.resume=false"])
    cfg = cfg.replace(optim=OptimConfig(**ocfg))
    task = SegmentWindowTask(cfg, tiny=True,
                             bert_cfg=_no_dropout(BertConfig.tiny()),
                             head_dropout=0.0)
    assert task.model.vision_model.remat
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
