"""The port's from-scratch GPT against the JAX package's, on the CPU.

- GPT logits (float32, atol 1e-5) for pre-norm and post-norm, learnable
  and sinusoidal positions, token ids and GloVe inputs, weights carried
  across by models/convert.py:gpt_entries (norms, biases and the
  learnable positions made random).
- interleaved_sinusoidal equal; gpt_loss within 1e-6; sample_next's
  greedy ids equal with top_k, its sampled ids inside the top k.
- gpt_generate greedy ids equal, with ragged prompt_len and an EOS.
- Three Trainer steps of GptPretrainTask and GptGlovePretrainTask in
  float64 (dropout off) on the GPT data sets' batches against the JAX
  model and optimizer: losses and every parameter at 1e-9 relative.
- cli/pretrain_lang --task next_token_gpt|next_token_glove --tiny
  --device cpu, then cli/sample_lang on its checkpoint (a random GloVe
  text file written here): the contract, greedy runs equal, sampled runs
  with one seed equal, and the GPT's greedy ids equal the JAX
  gpt_generate on the same checkpoint's weights.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_models import _perturb
from video_chapter_generation_tpu.core.config import (
    OptimConfig as JaxOptimConfig,
)
from video_chapter_generation_tpu.models import gpt as jax_gpt
from video_chapter_generation_tpu.train import optim as jax_optim
from video_chapter_generation_tpu.train.objectives import (
    masked_token_loss as jax_masked_token_loss,
)
from video_chapter_generation_tpu_torch.cli import pretrain_lang, sample_lang
from video_chapter_generation_tpu_torch.core.checkpoint import (
    CheckpointManager,
)
from video_chapter_generation_tpu_torch.core.config import Config, OptimConfig
from video_chapter_generation_tpu_torch.core.contract import vocab_hash
from video_chapter_generation_tpu_torch.data import corpus, datasets, synth
from video_chapter_generation_tpu_torch.data.loader import collate
from video_chapter_generation_tpu_torch.datasetkit.glove import (
    build_word_vocab,
)
from video_chapter_generation_tpu_torch.datasetkit.parsing import (
    text_decontracted,
)
from video_chapter_generation_tpu_torch.models import convert
from video_chapter_generation_tpu_torch.models.gpt import (
    GPT,
    GPTConfig,
    gpt_generate,
    gpt_loss,
    interleaved_sinusoidal,
    sample_next,
)
from video_chapter_generation_tpu_torch.train.loop import Trainer
from video_chapter_generation_tpu_torch.train.tasks import (
    GptGlovePretrainTask,
    GptPretrainTask,
)

V, L, B, EMB = 40, 12, 3, 16
TOL = dict(rtol=1e-5, atol=1e-5)
OCFG = dict(learning_rate=1e-3, weight_decay=0.01, grad_norm_clip=0.5,
            warmup_epochs=2, final_epochs=4, lr_decay=True,
            lr_decay_type="cosine")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw) -> GPTConfig:
    base = dict(vocab_size=V, block_size=24, n_layer=2, n_head=2,
                n_embd=EMB)
    return GPTConfig(**{**base, **kw})


def _jax_cfg(cfg: GPTConfig):
    return jax_gpt.GPTConfig(**dataclasses.asdict(cfg))


def _models(cfg: GPTConfig, seed: int):
    """(port GPT, JAX GPT, JAX params): random weights carried across."""
    entries = convert.gpt_entries(cfg)
    with torch.device("meta"):
        port = GPT(cfg)
    tree = _perturb(convert.random_jax_tree(port, entries, seed=seed),
                    np.random.default_rng(seed),
                    leaves=("scale", "bias", "pos_emb"))
    port.load_state_dict(convert.from_jax(tree, entries), assign=True)
    return port.eval(), jax_gpt.GPT(_jax_cfg(cfg)), tree["params"]


def _inputs(cfg: GPTConfig, rng, t: int = 10):
    if cfg.using_pretrained_embed:
        return rng.standard_normal((B, t, cfg.n_embd)).astype(np.float32)
    return rng.integers(0, cfg.vocab_size, (B, t)).astype(np.int32)


@pytest.mark.parametrize("pre_norm", [True, False])
@pytest.mark.parametrize("learnable", [True, False])
@pytest.mark.parametrize("glove", [False, True])
def test_gpt_logits_match_jax(pre_norm, learnable, glove):
    cfg = _cfg(pre_norm=pre_norm, learnable_pos_emb=learnable,
               using_pretrained_embed=glove)
    port, jmodel, params = _models(cfg, seed=1)
    x = _inputs(cfg, np.random.default_rng(2))
    want = jmodel.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == (B, 10, V)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("length,d", [(7, 10), (128, 300)])
def test_interleaved_sinusoidal_matches_jax(length, d):
    np.testing.assert_array_equal(interleaved_sinusoidal(length, d),
                                  jax_gpt.interleaved_sinusoidal(length, d))


def test_gpt_loss_and_sample_next_match_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((B, L, V)).astype(np.float32)
    targets = rng.integers(0, V, (B, L)).astype(np.int32)
    targets[rng.random((B, L)) < 0.3] = -1
    want = jax_gpt.gpt_loss(jnp.asarray(logits), jnp.asarray(targets))[0]
    got = gpt_loss(torch.from_numpy(logits), torch.from_numpy(targets))[0]
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)

    t_logits = torch.from_numpy(logits)
    greedy = sample_next(t_logits, temperature=0.7, top_k=5)
    want = jax_gpt.sample_next(jax.random.PRNGKey(0), jnp.asarray(logits),
                               temperature=0.7, top_k=5)
    np.testing.assert_array_equal(greedy.numpy(), np.asarray(want))
    top5 = np.argsort(-logits[:, -1], axis=-1)[:, :5]
    g = torch.Generator().manual_seed(0)
    for _ in range(20):
        drawn = sample_next(t_logits, top_k=5, sample=True,
                            generator=g).numpy()
        assert all(drawn[i] in top5[i] for i in range(B))


def test_gpt_generate_greedy_matches_jax():
    cfg = _cfg()
    port, jmodel, params = _models(cfg, seed=4)
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, V, (B, 6)).astype(np.int32)
    plen = np.array([6, 3, 4], np.int32)
    free = jax_gpt.gpt_generate(jmodel, {"params": params},
                                jnp.asarray(prompt), jnp.asarray(plen),
                                max_new_tokens=8)
    eos = int(np.asarray(free)[1, 2])  # row 1 reaches it at step 2
    want = jax_gpt.gpt_generate(jmodel, {"params": params},
                                jnp.asarray(prompt), jnp.asarray(plen),
                                max_new_tokens=8, eos_token_id=eos)
    got = gpt_generate(port, torch.from_numpy(prompt).long(),
                       torch.from_numpy(plen), max_new_tokens=8,
                       eos_token_id=eos)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[1, 2:] == eos).all()
    np.testing.assert_array_equal(
        gpt_generate(port, torch.from_numpy(prompt).long(),
                     torch.from_numpy(plen), max_new_tokens=8).numpy(),
        np.asarray(free))


@pytest.fixture(scope="module")
def gpt_corpus(tmp_path_factory):
    """A synthetic corpus on disk, its word vocabulary and a random
    16-wide GloVe text file over it."""
    root = tmp_path_factory.mktemp("gpt")
    paths = synth.make_synth_corpus_on_disk(
        str(root / "corpus"), n_videos=4, video_sec=40, hw=32,
        splits={"train": 4})
    c = corpus.VideoCorpus.from_files(paths["img_dir"], paths["data_file"],
                                      paths["train_vid_file"],
                                      paths["subtitle_dir"])
    words = build_word_vocab(c)
    rng = np.random.default_rng(6)
    glove = root / "glove.txt"
    glove.write_text("".join(
        w + " " + " ".join(f"{v:.6f}" for v in rng.standard_normal(EMB))
        + "\n" for w in words))
    return paths, c, words, glove


@pytest.mark.parametrize("glove", [False, True])
def test_gpt_pretrain_trajectory_matches_jax_float64(gpt_corpus, tmp_path,
                                                     glove):
    _, c, words, glove_file = gpt_corpus
    cfg = Config().apply_overrides([
        "model.compute_dtype=float64", "train.resume=false",
        f"data.max_text_len={L}", f"train.ckpt_dir={tmp_path / 'ckpt'}",
        f"train.log_dir={tmp_path / 'logs'}"])
    cfg = cfg.replace(optim=OptimConfig(**OCFG))
    off = dict(embd_pdrop=0.0, attn_pdrop=0.0, resid_pdrop=0.0)
    if glove:
        table = pretrain_lang.load_glove(str(glove_file))
        ds = datasets.GloveSubtitleDataset(c, table, words, max_text_len=L,
                                           emb_dim=EMB, seed=7)
        task = GptGlovePretrainTask(cfg, len(words), emb_dim=EMB, gpt_cfg=_cfg(
            block_size=L, using_pretrained_embed=True, **off))
        key, kind = "embeddings", "gpt_glove_pretrain"
    else:
        ds = datasets.WordIdSubtitleDataset(c, words, max_text_len=L,
                                            seed=7)
        task = GptPretrainTask(cfg, len(words), gpt_cfg=_cfg(block_size=L,
                                                             **off))
        key, kind = "text_ids", "gpt_pretrain"
    assert task.contract["model_kind"] == kind
    batches = [collate([ds.__getitem__(i, epoch) for i in range(B)])
               for epoch in range(3)]
    assert all((b["targets"] != -1).any() for b in batches)
    tree = _perturb(convert.random_jax_tree(task.model, task.entries,
                                            seed=9),
                    np.random.default_rng(9), leaves=("scale", "bias"))
    init = convert.from_jax(tree, task.entries)

    jmodel = jax_gpt.GPT(_jax_cfg(task.gpt_cfg), dtype=jnp.float64)
    jax_losses = []
    with jax.enable_x64(True):
        params = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), tree["params"])
        joc = JaxOptimConfig(**OCFG)
        tx = jax_optim.make_optimizer(joc, params)
        state = tx.init(params)

        def loss_fn(p, b):
            logits = jmodel.apply({"params": p}, b[key])
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
        want = {k: convert._to_torch_layout(
            np.asarray(convert._get(final, path), np.float64), kd)
            for path, k, kd in task.entries}

    task.init_state = lambda: {k: v.double() for k, v in init.items()}
    trainer = Trainer(cfg, task, lambda epoch: [batches[epoch]],
                      device="cpu")
    losses = [trainer.run_epoch(epoch)["loss"] for epoch in range(3)]
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-9)
    got = trainer.model.state_dict()
    # atol floor: the attention key biases get exactly zero gradient in
    # exact arithmetic (softmax ignores a per-query constant)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-9,
                                   atol=1e-12 + 1e-9 * np.abs(w).max(),
                                   err_msg=k)
    assert any(not torch.equal(got[k].float(), init[k]) for k in init)


@pytest.mark.parametrize("task_name", ["next_token_gpt", "next_token_glove"])
def test_pretrain_lang_then_sample_lang_gpt(gpt_corpus, tmp_path, task_name):
    paths, _, words, glove_file = gpt_corpus
    over = [f"data.{k}={paths[k]}" for k in (
        "img_dir", "data_file", "subtitle_dir", "train_vid_file")] + [
        "data.batch_size=2", "data.max_text_len=32", "train.max_epochs=2",
        "train.resume=false", "model.compute_dtype=float32",
        f"train.ckpt_dir={tmp_path / 'ck'}",
        f"train.log_dir={tmp_path / 'logs'}"]
    extra = ["--tiny", "--device", "cpu", "--task", task_name]
    if task_name == "next_token_glove":
        extra += ["--glove", str(glove_file)]
    trainer = pretrain_lang.main(over + extra)
    assert trainer.step == 4
    ck = CheckpointManager(str(tmp_path / "ck"))
    kind = ("gpt_pretrain" if task_name == "next_token_gpt"
            else "gpt_glove_pretrain")
    assert ck.model_kind(ck.latest_step()) == kind
    contract = ck.metrics_for(ck.latest_step())["contract"]
    assert contract["vocab_hash"] == vocab_hash(words)
    assert contract.get("emb_dim") == (EMB if "glove" in task_name else None)

    def run(*flags):
        return sample_lang.main(over + extra + ["--max_new_tokens", "6",
                                                "--num_samples", "2",
                                                "--top_k", "10", *flags])

    greedy = run("--greedy")
    assert [s["ids"] for s in greedy] == [s["ids"] for s in run("--greedy")]
    drawn = run()
    assert len(drawn) == 4 and all(len(s["ids"]) == 6 for s in drawn)
    assert [s["ids"] for s in drawn] == [s["ids"] for s in run()]
    for s in greedy + drawn:
        assert s["text"] == " ".join(words[i] for i in s["ids"])
    if task_name != "next_token_gpt":
        return
    # the same checkpoint through the JAX sampler, greedy
    _, state = ck.restore_latest()
    task = trainer.task
    tree: dict = {}
    for path, key, kd in task.entries:
        convert._put(tree, path, convert._to_jax_layout(
            state["model"][key].float().numpy(), kd))
    jmodel = jax_gpt.GPT(_jax_cfg(task.gpt_cfg))
    token2id = {w: i for i, w in enumerate(words)}
    for s in greedy[::2]:
        ctx = [token2id[w] for w in text_decontracted(s["prompt"]).split(" ")
               if w in token2id]
        want = jax_gpt.gpt_generate(jmodel, tree, jnp.asarray([ctx]),
                                    max_new_tokens=6)
        assert s["ids"] == np.asarray(want)[0].tolist()
