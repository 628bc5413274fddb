"""Title training on the port against the JAX package, on the CPU.

- seq2seq_title_loss against the JAX loss (float32, 1e-6).
- The teacher-forced forward (`Seq2Seq.forward`) against the JAX
  `Seq2Seq.__call__` for tiny Pegasus, BART and BigBird (128 tokens in
  blocks of 16: block-sparse, on the gather route), deterministic,
  float32: logits within 1e-5 of the largest logit's magnitude; and
  `Seq2SeqVisionEmb.forward` for both fusion heads the same way.
- BigBird's gather formulation: output and the gradients of q, k and v
  against the JAX `impl="gather"` ones in float64 (1e-10 relative); the
  "auto" route takes it under autograd and the kernel route under
  no_grad; "kernel" under autograd raises, as JAX does.
- Three Trainer steps of TitleGenTask in float64 (dropout 0) against the
  JAX optimizer stack, with gradient_accumulation_steps 1 and 2
  (optax.MultiSteps): losses at 1e-9 relative, every parameter at 1e-7
  relative; a run resumed from a checkpoint saved mid-cycle equals the
  run that was not interrupted, bit for bit.
- remat equal to no remat bit for bit with dropout on; dropout follows
  its generator; cli/train_title --tiny for each family and for the
  vision-conditioned model, and cli/infer_video restoring its checkpoint
  beside a boundary one.
"""

import dataclasses
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from video_chapter_generation_tpu.core.config import (
    OptimConfig as JaxOptimConfig,
)
from video_chapter_generation_tpu.models import seq2seq as jax_s2s
from video_chapter_generation_tpu.models import sparse_attention as jax_sparse
from video_chapter_generation_tpu.train import optim as jax_optim
from video_chapter_generation_tpu.train.objectives import (
    seq2seq_title_loss as jax_title_loss,
)
from video_chapter_generation_tpu_torch.cli import infer_video, train_title
from video_chapter_generation_tpu_torch.core.checkpoint import (
    CheckpointManager,
)
from video_chapter_generation_tpu_torch.core.config import Config, OptimConfig
from video_chapter_generation_tpu_torch.data.corpus import VideoCorpus
from video_chapter_generation_tpu_torch.data.synth import (
    make_synth_corpus_on_disk,
)
from video_chapter_generation_tpu_torch.data.tokenization import (
    UnigramTokenizer,
)
from video_chapter_generation_tpu_torch.models import convert
from video_chapter_generation_tpu_torch.models import (
    sparse_attention as port_sparse,
)
from video_chapter_generation_tpu_torch.models.seq2seq import (
    Seq2Seq,
    Seq2SeqConfig,
    Seq2SeqVisionEmb,
)
from video_chapter_generation_tpu_torch.train.loop import Trainer
from video_chapter_generation_tpu_torch.train.objectives import (
    seq2seq_title_loss,
)
from video_chapter_generation_tpu_torch.train.tasks import TitleGenTask

VOCAB, B, L_DEC = 96, 2, 6
FAMILIES = {
    "pegasus": dict(),
    "bart": dict(activation="gelu", pre_norm=False, learned_positions=True,
                 position_offset=2, scale_embedding=False,
                 embed_layernorm=True, pad_token_id=1, eos_token_id=2,
                 decoder_start_token_id=2),
    "bigbird": dict(max_positions=256, encoder_attention="block_sparse",
                    block_size=16, num_rand_blocks=1, activation="gelu_new",
                    learned_positions=True, decoder_start_token_id=2,
                    attention_bias=False),
}
L_IN = {"pegasus": 24, "bart": 24, "bigbird": 128}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: many small ops, which a full pool only slows
    when other test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **kw):
    base = dict(vocab_size=VOCAB, **FAMILIES[arch], **kw)
    return Seq2SeqConfig.tiny(**base), jax_s2s.Seq2SeqConfig.tiny(
        sparse_impl="gather", **{k: v for k, v in base.items()
                                 if k != "sparse_impl"})


def _tree(model, entries, seed):
    """A seeded tree in the JAX layout, norm affines and the logits bias
    perturbed so that they show."""
    tree = convert.random_jax_tree(model, entries, seed=seed)
    rng = np.random.default_rng(seed)

    def walk(node, path=()):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            elif k in ("scale", "bias") or k == "final_logits_bias":
                node[k] = (v + 0.1 * rng.standard_normal(v.shape)).astype(
                    np.float32)

    walk(tree)
    return tree


def _inputs(arch, seed, cfg):
    """Encoder ids padded with the pad id where the mask is 0 (as the
    title data sets pad), decoder ids from the start token, one row with
    decoder padding."""
    rng = np.random.default_rng(seed)
    n = L_IN[arch]
    ids = rng.integers(3, VOCAB, (B, n)).astype(np.int32)
    mask = np.ones((B, n), np.int32)
    mask[1, n - 7:] = 0
    ids[mask == 0] = cfg.pad_token_id
    dec = rng.integers(3, VOCAB, (B, L_DEC)).astype(np.int32)
    dec[:, 0] = cfg.decoder_start_token_id
    dmask = np.ones((B, L_DEC), np.int32)
    dmask[0, 4:] = 0
    tgt = rng.integers(3, VOCAB, (B, L_DEC)).astype(np.int32)
    return {"text_ids": ids, "attention_mask": mask,
            "input_decode_ids": dec, "decode_attention_mask": dmask,
            "target_decode_ids": tgt}


def _port(cfg, tree, dtype=torch.float32):
    with torch.device("meta"):
        model = Seq2Seq(cfg)
    sd = convert.from_jax(tree, convert.seq2seq_entries(cfg))
    model.load_state_dict({k: v.to(dtype) for k, v in sd.items()},
                          assign=True)
    return model


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_title_loss_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 7, 11)).astype(np.float32)
    tgt = rng.integers(0, 11, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) > 0.3).astype(np.int32)
    tgt[0, :3] = logits[0, :3].argmax(-1)  # some hits for the accuracy
    loss, m = seq2seq_title_loss(_t(logits), _t(tgt), _t(mask))
    jloss, jm = jax_title_loss(jnp.asarray(logits), jnp.asarray(tgt),
                               jnp.asarray(mask))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    np.testing.assert_allclose(float(m["acc"]), float(jm["acc"]), rtol=1e-6)
    assert float(m["acc"]) > 0
    # a bf16 logit tensor reduces in float32
    assert seq2seq_title_loss(_t(logits).bfloat16(), _t(tgt),
                              _t(mask))[0].dtype == torch.float32


@pytest.mark.parametrize("arch", ["pegasus", "bart", "bigbird"])
def test_teacher_forced_forward_matches_jax(arch):
    cfg, jcfg = _cfgs(arch)
    with torch.device("meta"):
        meta = Seq2Seq(cfg)
    tree = _tree(meta, convert.seq2seq_entries(cfg), 10)
    b = _inputs(arch, 11, cfg)
    want = np.asarray(jax_s2s.Seq2Seq(jcfg).apply(
        {"params": tree}, b["text_ids"], b["attention_mask"],
        b["input_decode_ids"], b["decode_attention_mask"]))
    model = _port(cfg, tree).eval()
    got = model(_t(b["text_ids"]).long(), _t(b["attention_mask"]),
                _t(b["input_decode_ids"]).long(),
                _t(b["decode_attention_mask"])).detach().numpy()
    assert got.shape == (B, L_DEC, VOCAB) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    if arch == "bigbird":  # 8 blocks of 16: past the full-attention rule
        nb = L_IN[arch] // cfg.block_size
        assert nb > 5 + 2 * cfg.num_rand_blocks


@pytest.mark.parametrize("fusion", ["cross_attn", "mlp"])
def test_vision_forward_matches_jax(fusion):
    cfg, jcfg = _cfgs("pegasus")
    emb = 48
    with torch.device("meta"):
        meta = Seq2SeqVisionEmb(cfg, fusion, emb)
    entries = convert.vision_title_entries(cfg, fusion)
    tree = _tree(meta, entries, 12)
    b = _inputs("pegasus", 13, cfg)
    rng = np.random.default_rng(14)
    vis = rng.standard_normal((B, 5, emb)).astype(np.float32)
    vmask = np.asarray([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], np.int32)
    want = np.asarray(jax_s2s.Seq2SeqVisionEmb(
        jcfg, fusion_type=fusion, vision_emb_size=emb).apply(
        {"params": tree}, vis, vmask, b["text_ids"], b["attention_mask"],
        b["input_decode_ids"], b["decode_attention_mask"]))
    model = meta
    model.load_state_dict(convert.from_jax(tree, entries), assign=True)
    got = model.eval()(_t(vis), _t(vmask), _t(b["text_ids"]).long(),
                       _t(b["attention_mask"]),
                       _t(b["input_decode_ids"]).long(),
                       _t(b["decode_attention_mask"])).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_bigbird_gather_route_and_its_gradient_match_jax(monkeypatch):
    rng = np.random.default_rng(20)
    l, h, hd, bs, r = 128, 2, 16, 16, 1
    q, k, v = (rng.standard_normal((B, l, h, hd)) for _ in range(3))
    w = rng.standard_normal((B, l, h, hd))
    mask = np.ones((B, l), np.int32)
    mask[1, l - 21:] = 0

    with jax.enable_x64(True):
        def jloss(q, k, v):
            out = jax_sparse.block_sparse_attention(
                q, k, v, jnp.asarray(mask), bs, r, impl="gather")
            return (out * w).sum(), out

        (_, jout), jgrads = jax.value_and_grad(
            jloss, argnums=(0, 1, 2), has_aux=True)(
            *(jnp.asarray(a, jnp.float64) for a in (q, k, v)))
        jout, jgrads = np.asarray(jout), [np.asarray(g) for g in jgrads]

    calls = []
    real = port_sparse.sparse_band_attention
    monkeypatch.setattr(port_sparse, "sparse_band_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = port_sparse.block_sparse_attention(tq, tk, tv, _t(mask), bs, r)
    (out * _t(w)).sum().backward()
    assert not calls  # auto under autograd: the gather formulation
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=0,
                               atol=1e-10 * np.abs(jout).max())
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-10 * np.abs(want).max())
    with torch.no_grad():  # auto without gradients: the kernel route
        again = port_sparse.block_sparse_attention(tq, tk, tv, _t(mask), bs,
                                                   r)
    assert calls == [1]
    # K10's plain version computes the middle blocks in float32
    np.testing.assert_allclose(again.numpy(), jout, rtol=0,
                               atol=1e-6 * np.abs(jout).max())
    with pytest.raises(NotImplementedError, match="no backward"):
        port_sparse.block_sparse_attention(tq, tk, tv, _t(mask), bs, r,
                                           impl="kernel")
    with pytest.raises(ValueError, match="impl"):
        port_sparse.block_sparse_attention(tq, tk, tv, _t(mask), bs, r,
                                           impl="dense")


def _jax_trajectory(jcfg, tree, batches, ocfg, k):
    """The JAX package's optimizer stack (make_optimizer, MultiSteps for
    k > 1, set_lr_mult per epoch) on the JAX model, float64, one batch
    an epoch -> (losses, final params)."""
    model = jax_s2s.Seq2Seq(jcfg, dtype=jnp.float64)
    losses = []
    with jax.enable_x64(True):
        params = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), tree)
        joc = JaxOptimConfig(**ocfg, gradient_accumulation_steps=k)
        tx = jax_optim.make_optimizer(joc, params)
        state = tx.init(params)

        def loss_fn(p, b):
            logits = model.apply({"params": p}, b["text_ids"],
                                 b["attention_mask"], b["input_decode_ids"],
                                 b["decode_attention_mask"])
            return jax_title_loss(logits, b["target_decode_ids"],
                                  b["decode_attention_mask"])[0]

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
                params, state, {k_: jnp.asarray(v) for k_, v in batch.items()})
            losses.append(float(loss))
        params = jax.tree_util.tree_map(np.asarray, params)
    return losses, params


OCFG = dict(learning_rate=1e-3, weight_decay=0.01, grad_norm_clip=0.5,
            warmup_epochs=2, final_epochs=4, lr_decay=True,
            lr_decay_type="cosine")


def _trainer(tmp_path, cfg, tree, batches, k, **train):
    over = ["model.compute_dtype=float64", "train.resume=false",
            f"train.ckpt_dir={tmp_path / 'ckpt'}",
            f"train.log_dir={tmp_path / 'logs'}"]
    over += [f"train.{a}={b}" for a, b in train.items()]
    c = Config().apply_overrides(over)
    c = c.replace(optim=OptimConfig(**OCFG, gradient_accumulation_steps=k))
    task = TitleGenTask(c, cfg)
    task.init_state = lambda: {
        kk: v.double() for kk, v in
        convert.from_jax(tree, convert.seq2seq_entries(cfg)).items()}
    return Trainer(c, task, lambda epoch: [batches[epoch]], device="cpu")


@pytest.mark.parametrize("k", [1, 2])
def test_title_trainer_trajectory_matches_jax_float64(tmp_path, k):
    cfg, jcfg = _cfgs("pegasus", dropout=0.0)
    jcfg = dataclasses.replace(jcfg, dropout=0.0)
    with torch.device("meta"):
        meta = Seq2Seq(cfg)
    tree = _tree(meta, convert.seq2seq_entries(cfg), 30)
    batches = [_inputs("pegasus", 31 + i, cfg) for i in range(3)]
    jax_losses, jparams = _jax_trajectory(jcfg, tree, batches, OCFG, k)

    trainer = _trainer(tmp_path, cfg, tree, batches, k)
    losses = [trainer.run_epoch(epoch)["loss"] for epoch in range(3)]
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-9)
    assert trainer.step == 3
    entries = convert.seq2seq_entries(cfg)
    want = {key: convert._to_torch_layout(
        np.asarray(convert._get(jparams, path)), kind)
        for path, key, kind in entries}
    init = convert.from_jax(tree, entries)
    got = trainer.model.state_dict()
    for key, w in want.items():
        np.testing.assert_allclose(got[key].double().numpy(), w, rtol=1e-7,
                                   atol=1e-10 + 1e-7 * np.abs(w).max(),
                                   err_msg=key)
    assert any(not torch.equal(got[key], init[key].double()) for key in want)
    if k == 2:  # the third micro-step is mid-cycle: its gradient is kept
        assert all(p.grad is not None for p in trainer.model.parameters())


def test_accumulation_resumes_mid_cycle(tmp_path):
    cfg, _ = _cfgs("pegasus", dropout=0.0)
    with torch.device("meta"):
        meta = Seq2Seq(cfg)
    tree = _tree(meta, convert.seq2seq_entries(cfg), 40)
    batches = [_inputs("pegasus", 41 + i, cfg) for i in range(3)]
    whole = _trainer(tmp_path / "a", cfg, tree, batches, 2, max_epochs=3)
    whole.train()
    first = _trainer(tmp_path / "b", cfg, tree, batches, 2, max_epochs=1)
    first.train()  # saves epoch 0 with one micro-step folded in
    assert CheckpointManager(str(tmp_path / "b" / "ckpt")).steps() == [0]
    c = Config().apply_overrides([
        "model.compute_dtype=float64", "train.resume=true",
        "train.max_epochs=3", f"train.ckpt_dir={tmp_path / 'b' / 'ckpt'}",
        f"train.log_dir={tmp_path / 'b' / 'logs'}"])
    c = c.replace(optim=OptimConfig(**OCFG, gradient_accumulation_steps=2))
    task = TitleGenTask(c, cfg)
    task.init_state = first.task.init_state
    resumed = Trainer(c, task, lambda epoch: [batches[epoch]], device="cpu")
    assert resumed.start_epoch == 1 and resumed.step == 1
    saved = CheckpointManager(str(tmp_path / "b" / "ckpt")).restore_raw(0)
    grads = dict(first.model.named_parameters())
    assert saved[1]["grads"].keys() == grads.keys()
    for name, p in resumed.model.named_parameters():
        assert torch.equal(p.grad, grads[name].grad), name
    resumed.train()
    a, b = whole.model.state_dict(), resumed.model.state_dict()
    assert all(torch.equal(a[key], b[key]) for key in a)
    assert resumed.step == whole.step == 3


@pytest.mark.parametrize("arch", ["pegasus", "bigbird"])
def test_remat_equals_no_remat_bitwise_with_dropout(arch):
    cfg, _ = _cfgs(arch, dropout=0.1)
    with torch.device("meta"):
        meta = Seq2Seq(cfg)
    tree = _tree(meta, convert.seq2seq_entries(cfg), 50)
    b = _inputs(arch, 51, cfg)
    runs = []
    for remat in (False, True):
        model = _port(dataclasses.replace(cfg, remat=remat), tree).train()
        gen = torch.Generator().manual_seed(7)
        logits = model(_t(b["text_ids"]).long(), _t(b["attention_mask"]),
                       _t(b["input_decode_ids"]).long(),
                       _t(b["decode_attention_mask"]), generator=gen)
        loss, _ = seq2seq_title_loss(logits, _t(b["target_decode_ids"]),
                                     _t(b["decode_attention_mask"]))
        loss.backward()
        runs.append((loss.detach(), {n: p.grad.clone()
                                     for n, p in model.named_parameters()}))
    (l0, g0), (l1, g1) = runs
    assert torch.equal(l0, l1)
    assert all(torch.equal(g0[n], g1[n]) for n in g0)


def test_dropout_follows_its_generator():
    cfg, _ = _cfgs("bart", dropout=0.3)
    with torch.device("meta"):
        meta = Seq2Seq(cfg)
    tree = _tree(meta, convert.seq2seq_entries(cfg), 60)
    b = _inputs("bart", 61, cfg)
    model = _port(cfg, tree).train()
    args = (_t(b["text_ids"]).long(), _t(b["attention_mask"]),
            _t(b["input_decode_ids"]).long(), _t(b["decode_attention_mask"]))
    run = lambda seed: model(  # noqa: E731
        *args, generator=torch.Generator().manual_seed(seed)).detach()
    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))
    off = _port(dataclasses.replace(cfg, dropout=0.0), tree).train()
    model.eval()
    assert torch.equal(run(1), run(2))
    assert torch.equal(run(1), off(*args).detach())


@pytest.fixture(scope="module")
def title_corpus(tmp_path_factory):
    """A synthetic corpus, chapter vision embeddings in
    cli/extract_vision_emb's layout, and a title tokenizer written as a
    piece table (train_title and infer_video must share it: the
    checkpoint's vocab_hash)."""
    root = tmp_path_factory.mktemp("titles")
    paths = make_synth_corpus_on_disk(str(root), n_videos=6, video_sec=64,
                                      hw=64, splits={"train": 4, "val": 1,
                                                     "test": 1})
    rng = np.random.default_rng(0)
    emb_dir = root / "embs"
    corpus = VideoCorpus.from_files(paths["img_dir"], paths["data_file"],
                                    paths["train_vid_file"],
                                    paths["subtitle_dir"])
    for name in ("train_vid_file", "val_vid_file", "test_vid_file"):
        for vid in open(paths[name]).read().split():
            os.makedirs(emb_dir / vid, exist_ok=True)
            for st in range(0, 64, 4):
                np.save(emb_dir / vid / f"vision_emb_{st}_{st + 16}.npy",
                        rng.standard_normal((16, 2048)).astype(np.float32))
    tok = UnigramTokenizer.build_from_corpus(
        [s["text"] for vid in corpus.vids for s in corpus.subtitles(vid)],
        vocab_size=300)
    tsv = root / "pieces.tsv"
    tsv.write_text("".join(f"{p}\t{v}\n" for p, v in tok.pieces.items()))
    return paths, str(emb_dir), str(tsv)


def _title_argv(paths, tmp, tsv, *extra):
    return [f"data.img_dir={paths['img_dir']}",
            f"data.data_file={paths['data_file']}",
            f"data.subtitle_dir={paths['subtitle_dir']}",
            f"data.train_vid_file={paths['train_vid_file']}",
            f"data.val_vid_file={paths['val_vid_file']}",
            f"data.test_vid_file={paths['test_vid_file']}",
            "model.compute_dtype=float32", "data.batch_size=2",
            "data.title_input_len=32", "data.title_decode_len=8",
            "data.clip_frame_num=4", "data.max_text_len=16",
            "optim.learning_rate=0.001", "train.max_epochs=2",
            "train.eval_every_epochs=1", f"train.ckpt_dir={tmp}/ckpt",
            f"train.log_dir={tmp}/logs", "train.resume=false",
            *extra, "--spm_tsv", tsv, "--tiny", "--device", "cpu"]


@pytest.mark.parametrize("case", [
    ["--remat"], ["--title_arch", "bigbird", "data.title_input_len=128"],
    ["--title_arch", "bart", "optim.gradient_accumulation_steps=2"],
    ["vision"]])
def test_train_title_cli_tiny(title_corpus, tmp_path, case, capsys,
                              monkeypatch):
    """cli/train_title trains each family (2 epochs of 2 batches, the
    eval each epoch); for Pegasus (under --remat) and the vision model,
    cli/infer_video then restores the best title checkpoint beside a
    better-scored boundary checkpoint in the same directory, and titles
    the test video from it."""
    paths, emb_dir, tsv = title_corpus
    vision = case == ["vision"]
    extra = [f"model.vision_init={emb_dir}"] if vision else case
    trainer = train_title.main(_title_argv(paths, tmp_path, tsv, *extra))
    assert trainer.step == 4
    ck = CheckpointManager(str(tmp_path / "ckpt"))
    assert ck.steps() == [0, 1]
    kind = "title_vision" if vision else "title"
    for epoch in (0, 1):
        m = ck.metrics_for(epoch)
        assert m["contract"]["model_kind"] == kind
        assert np.isfinite(m["score"]) and m["score"] < 0  # -mean eval loss
    if case == ["--remat"]:
        assert trainer.model.cfg.remat
    if case[0] == "--title_arch" and case[1] == "bart":
        assert trainer.cfg.optim.gradient_accumulation_steps == 2
        # 4 micro-steps, 2 AdamW updates
        assert all(int(st["step"]) == 2 for st in trainer.opt.state.values())
    if not (vision or case == ["--remat"]):
        return
    best = ck.best_step(kind)
    ck.save(5, {"model": {}, "step": 0}, score=1.0, metrics={
        "contract": {"model_kind": "two_stream"}})
    monkeypatch.chdir(tmp_path)
    capsys.readouterr()
    argv = _title_argv(paths, tmp_path, tsv, "model.kind=two_stream",
                       "model.stem_input=frames")
    if vision:
        argv += ["--vision_emb_dir", emb_dir]
    # a stand-in boundary scorer, positive on every fifth clip: the
    # boundary weights' restore is tests/test_torch_infer.py's
    monkeypatch.setattr(infer_video, "build_score_fn", lambda *a, **kw: (
        lambda batch: np.where(np.asarray(batch["clip_index"]) % 5 == 2,
                               0.9, 0.1).astype(np.float32)))
    results = infer_video.main(argv)
    out = capsys.readouterr().out
    assert f"restored checkpoint at epoch {best}" in out
    assert "random title weights" not in out
    assert results and all(len(r.titles) == len(r.cut_points) >= 1
                           for r in results.values())
    assert ck.best_step("two_stream") == 5 and ck.best_step() == 5
