"""BERT subtitle pretraining and the grouped optimizer on the port
against the JAX package, on the CPU.

- mlm_mask and SubtitlePretrainDataset items (mlm and next_token, two
  epochs) bit for bit the JAX ones, on the same synthetic corpus written
  by both packages.
- masked_token_loss against the JAX one within 1e-6 (float32 and bf16
  logits, which both reduce in float32).
- Three Trainer steps of LangPretrainTask in float64 (dropout off) on
  SubtitlePretrainDataset batches, for mlm and next_token, against the
  JAX model and optimizer stack: losses at 1e-9 relative, every
  parameter at 1e-9 relative.
- make_grouped_optimizer over three float64 steps of the same seeded
  gradients against the JAX optax chain, on the tiny TwoStream (a BERT
  and a ResNet backbone, the head at 2x): every parameter at 1e-9
  relative.
- cli/pretrain_lang --task mlm|next_token --tiny --device cpu writes a
  checkpoint that restores into LangPretrainTask's model; an unknown
  task names every served one, the GPT tasks among them.
- temporal_pool against the JAX one, float32 and int8. The JAX function
  raises on int8 (its reduce_window takes the Python int minimum as an
  int32 init value), so int8 is held to it on the same values as int32.
"""

import dataclasses
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_models import _perturb
from video_chapter_generation_tpu.core.config import (
    OptimConfig as JaxOptimConfig,
)
from video_chapter_generation_tpu.data import corpus as jax_corpus
from video_chapter_generation_tpu.data import datasets as jax_datasets
from video_chapter_generation_tpu.data import synth as jax_synth
from video_chapter_generation_tpu.data import tokenization as jax_tok
from video_chapter_generation_tpu.models.bert import (
    BertConfig as JaxBertConfig,
    BertForChapter as JaxBertForChapter,
)
from video_chapter_generation_tpu.ops.temporal_shift import (
    temporal_pool as jax_temporal_pool,
)
from video_chapter_generation_tpu.train import optim as jax_optim
from video_chapter_generation_tpu.train.objectives import (
    masked_token_loss as jax_masked_token_loss,
)
from video_chapter_generation_tpu_torch.cli import pretrain_lang
from video_chapter_generation_tpu_torch.cli.common import parse_config
from video_chapter_generation_tpu_torch.core.checkpoint import (
    CheckpointManager,
)
from video_chapter_generation_tpu_torch.core.config import Config, OptimConfig
from video_chapter_generation_tpu_torch.core.contract import vocab_hash
from video_chapter_generation_tpu_torch.data import corpus, datasets, synth
from video_chapter_generation_tpu_torch.data.loader import collate
from video_chapter_generation_tpu_torch.data.tokenization import (
    WordPieceTokenizer,
)
from video_chapter_generation_tpu_torch.models import convert
from video_chapter_generation_tpu_torch.models.bert import BertConfig
from video_chapter_generation_tpu_torch.ops.temporal_shift import (
    temporal_pool,
)
from video_chapter_generation_tpu_torch.train.loop import Trainer
from video_chapter_generation_tpu_torch.train.objectives import (
    masked_token_loss,
)
from video_chapter_generation_tpu_torch.train.optim import (
    lr_multiplier,
    make_grouped_optimizer,
    set_lr_mult,
)
from video_chapter_generation_tpu_torch.train.tasks import (
    LangPretrainTask,
    SegmentTask,
)

L, B = 16, 3
OCFG = dict(learning_rate=1e-3, weight_decay=0.01, grad_norm_clip=0.5,
            warmup_epochs=2, final_epochs=4, lr_decay=True,
            lr_decay_type="cosine")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """The same synthetic corpus written by both packages, with each
    package's tokenizer built from it."""
    kw = dict(n_videos=4, video_sec=40, hw=32, splits={"train": 4})
    a = synth.make_synth_corpus_on_disk(
        str(tmp_path_factory.mktemp("port")), **kw)
    b = jax_synth.make_synth_corpus_on_disk(
        str(tmp_path_factory.mktemp("jax")), **kw)
    out = []
    for paths, mod, tok_mod in ((a, corpus, WordPieceTokenizer),
                                (b, jax_corpus, jax_tok.WordPieceTokenizer)):
        c = mod.VideoCorpus.from_files(paths["img_dir"], paths["data_file"],
                                       paths["train_vid_file"],
                                       paths["subtitle_dir"])
        texts = [s["text"] for vid in c.vids for s in c.subtitles(vid)]
        out.append((paths, c, tok_mod.build_from_corpus(texts, 200)))
    return out


def test_mlm_mask_matches_jax():
    for seed in range(20):
        rng = np.random.default_rng(seed)
        ids = rng.integers(0, 50, 24).astype(np.int32)
        mask = (np.arange(24) < rng.integers(0, 25)).astype(np.int32)
        specials = (2, 3)
        got = datasets.mlm_mask(ids, mask, 50, 4, np.random.default_rng(
            seed + 100), specials)
        want = jax_datasets.mlm_mask(ids, mask, 50, 4, np.random.default_rng(
            seed + 100), specials)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert datasets.Y_PAD == jax_datasets.Y_PAD


@pytest.mark.parametrize("task", ["mlm", "next_token"])
def test_subtitle_pretrain_items_match_jax(corpora, task):
    (_, ca, ta), (_, cb, tb) = corpora
    da = datasets.SubtitlePretrainDataset(ca, ta, task=task, max_text_len=L,
                                          seed=5)
    db = jax_datasets.SubtitlePretrainDataset(cb, tb, task=task,
                                              max_text_len=L, seed=5)
    assert len(da) == len(db) == 4
    masked = 0
    for epoch in (0, 1):
        for i in range(len(da)):
            a, b = da.__getitem__(i, epoch), db.__getitem__(i, epoch)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
            masked += int((a["targets"] != datasets.Y_PAD).sum())
    assert masked > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_token_loss_matches_jax(dtype):
    rng = np.random.default_rng(3)
    logits = (3 * rng.standard_normal((B, L, 40))).astype(np.float32)
    targets = rng.integers(0, 40, (B, L)).astype(np.int32)
    targets[rng.random((B, L)) < 0.6] = -1
    t = torch.from_numpy(logits).to(dtype)
    loss, m = masked_token_loss(t, torch.from_numpy(targets))
    jl = jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    want, wm = jax_masked_token_loss(jl, jnp.asarray(targets))
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(want), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(m["acc"]), float(wm["acc"]), rtol=0,
                               atol=1e-6)
    none = masked_token_loss(t, torch.full((B, L), -1))[0]
    assert float(none) == 0.0


def _no_dropout(cfg):
    return dataclasses.replace(cfg, hidden_dropout=0.0, attention_dropout=0.0)


@pytest.mark.parametrize("task_name", ["mlm", "next_token"])
def test_lang_pretrain_trajectory_matches_jax_float64(corpora, tmp_path,
                                                      task_name):
    (_, ca, tok), _ = corpora
    vocab = tok.vocab_size
    ds = datasets.SubtitlePretrainDataset(ca, tok, task=task_name,
                                          max_text_len=L, seed=7)
    batches = [collate([ds.__getitem__(i, epoch) for i in range(B)])
               for epoch in range(3)]
    cfg = Config().apply_overrides([
        "model.compute_dtype=float64", "train.resume=false",
        f"data.max_text_len={L}", f"train.ckpt_dir={tmp_path / 'ckpt'}",
        f"train.log_dir={tmp_path / 'logs'}"])
    cfg = cfg.replace(optim=OptimConfig(**OCFG))
    task = LangPretrainTask(cfg, vocab, bert_cfg=_no_dropout(
        BertConfig.tiny()))
    assert task.contract == {"model_kind": "lang_pretrain",
                             "max_text_len": L, "vocab_size": vocab}
    tree = convert.random_jax_tree(task.model, task.entries, seed=9)
    init = convert.from_jax(tree, task.entries)

    model = JaxBertForChapter(_no_dropout(JaxBertConfig.tiny(vocab)),
                              pretrain_stage=True, dtype=jnp.float64)
    jax_losses = []
    with jax.enable_x64(True):
        params = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), tree["params"])
        joc = JaxOptimConfig(**OCFG)
        tx = jax_optim.make_optimizer(joc, params)
        state = tx.init(params)

        def loss_fn(p, b):
            logits, _ = model.apply({"params": p}, b["text_ids"],
                                    b["attention_mask"])
            return jax_masked_token_loss(logits, b["targets"])[0]

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
            for path, key, kind in task.entries}

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
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-9,
                                   atol=1e-12 + 1e-9 * np.abs(w).max(),
                                   err_msg=k)
    assert any(not torch.equal(got[k].float(), init[k]) for k in init)


def test_grouped_optimizer_matches_optax_float64(tmp_path):
    cfg = Config().apply_overrides(["data.clip_frame_num=4",
                                    "model.hidden_size=16"])
    task = SegmentTask(cfg, tiny=True, hw=32)
    tree = _perturb(convert.random_jax_tree(task.model, task.entries,
                                            seed=3),
                    np.random.default_rng(3))
    net = task.model
    net.load_state_dict(convert._with_bn_counters(
        convert.from_jax(tree, task.entries)), assign=True)
    net.double()
    rng = np.random.default_rng(4)
    grads = [jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape) * 1e-2, tree["params"])
        for _ in range(3)]
    ocfg = OptimConfig(**OCFG)
    joc = JaxOptimConfig(**OCFG)

    with jax.enable_x64(True):
        params = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), tree["params"])
        tx = jax_optim.make_grouped_optimizer(joc, params)
        state = tx.init(params)

        @jax.jit
        def step(p, st, g):
            upd, st = tx.update(g, st, p)
            return jax.tree_util.tree_map(lambda a, u: a + u, p, upd), st

        for epoch, g in enumerate(grads):
            state = jax_optim.set_lr_mult(
                state, jax_optim.lr_multiplier(epoch, joc))
            params, state = step(params, state, g)
        final = {"params": jax.tree_util.tree_map(np.asarray, params)}

    opt = make_grouped_optimizer(ocfg, net, task.entries)
    assert sorted((g["lr_scale"], g["weight_decay"] > 0)
                  for g in opt.param_groups) == [
        (1.0, False), (1.0, True), (2.0, False), (2.0, True)]
    named = dict(net.named_parameters())
    for epoch, g in enumerate(grads):
        set_lr_mult(opt, ocfg, lr_multiplier(epoch, ocfg))
        for path, key, kind in task.entries:
            if key in named:
                named[key].grad = torch.from_numpy(convert._to_torch_layout(
                    np.asarray(convert._get({"params": g}, path)), kind))
        torch.nn.utils.clip_grad_norm_(net.parameters(), ocfg.grad_norm_clip)
        opt.step()
    moved = 0
    for path, key, kind in task.entries:
        if key not in named:
            continue
        w = convert._to_torch_layout(
            np.asarray(convert._get(final, path), np.float64), kind)
        got = named[key].detach().numpy()
        np.testing.assert_allclose(got, w, rtol=1e-9,
                                   atol=1e-12 + 1e-9 * np.abs(w).max(),
                                   err_msg=key)
        moved += not np.array_equal(got, convert._to_torch_layout(
            np.asarray(convert._get(tree, path), np.float64), kind))
    assert moved == len(named)


@pytest.mark.parametrize("task_name", ["mlm", "next_token"])
def test_pretrain_lang_cli_writes_a_restorable_checkpoint(corpora, tmp_path,
                                                          task_name):
    (paths, _, _), _ = corpora
    over = [f"data.img_dir={paths['img_dir']}",
            f"data.data_file={paths['data_file']}",
            f"data.subtitle_dir={paths['subtitle_dir']}",
            f"data.train_vid_file={paths['train_vid_file']}",
            "data.batch_size=2", f"data.max_text_len={L}",
            "train.max_epochs=2", "train.resume=false",
            "optim.learning_rate=1e-3", f"train.ckpt_dir={tmp_path / 'ck'}",
            f"train.log_dir={tmp_path / 'logs'}"]
    trainer = pretrain_lang.main(over + ["--task", task_name, "--tiny",
                                         "--device", "cpu"])
    assert trainer.step == 4 and trainer.task.model.pretrain_stage
    ck = CheckpointManager(str(tmp_path / "ck"))
    assert ck.steps() == [0, 1] and ck.model_kind(1) == "lang_pretrain"
    _, state = ck.restore_latest()
    cfg, _ = parse_config(over + ["--tiny"])
    tok = trainer.train_loader.dataset.tokenizer
    assert ck.metrics_for(1)["contract"]["vocab_hash"] == vocab_hash(tok)
    fresh = LangPretrainTask(cfg, tok.vocab_size, tiny=True)
    fresh.model.load_state_dict(state["model"], assign=True)
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, state["model"][k]), k
    losses = [r["value"] for r in map(json.loads,
                                      open(tmp_path / "logs" /
                                           "scalars.jsonl"))
              if r["tag"] == "train/loss"]
    assert len(losses) == 2 and np.isfinite(losses).all()


@pytest.mark.parametrize("task_name", ["next_token_gpt", "next_token_glove"])
def test_pretrain_lang_gpt_tasks_name_their_item(task_name):
    """The GPT tasks are served now (tests/test_torch_gpt.py): an unknown
    task names them among the choices, and next_token_glove without
    --glove names the flag it needs."""
    with pytest.raises(SystemExit, match=f"mlm, next_token, .*{task_name}"):
        pretrain_lang.main(["--task", "cloze", "--device", "cpu"])
    if task_name == "next_token_glove":
        with pytest.raises(SystemExit, match="needs --glove"):
            pretrain_lang.main(["--task", task_name, "--device", "cpu"])


@pytest.mark.parametrize("dtype", [np.float32, np.int8])
@pytest.mark.parametrize("t", [1, 4, 5, 8])
def test_temporal_pool_matches_jax(dtype, t):
    rng = np.random.default_rng(t)
    if dtype == np.float32:
        x = rng.standard_normal((2 * t, 3, 2, 8)).astype(dtype)
        want = np.asarray(jax_temporal_pool(jnp.asarray(x), t))
    else:
        x = rng.integers(-128, 128, (2 * t, 3, 2, 8)).astype(dtype)
        want = np.asarray(jax_temporal_pool(
            jnp.asarray(x.astype(np.int32)), t)).astype(dtype)
    got = temporal_pool(torch.from_numpy(x), t).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape == (
        2 * ((t - 1) // 2 + 1), 3, 2, 8)
    np.testing.assert_array_equal(got, want)
