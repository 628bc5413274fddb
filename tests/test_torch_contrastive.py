"""MoCo and ListNet text training on the port against the JAX package on
the CPU.

- info_nce_loss and listnet_loss (with and without the auxiliary binary
  head) at 1e-6, float32.
- Two MoCo steps in float64 (BERT tiny, K 16, batch 4, 4 candidates; the
  step of the JAX cli/pretrain_contrastive.py on the JAX
  MoCoTextEncoder with a float64 BERT), the port's cli/pretrain_contrastive
  moco_step on the same MoCoState carried across (seeded numpy weights
  and queue in the structure of the JAX init_state): after each step the
  logits, the loss, every key-encoder parameter, the queue and the
  pointer at 1e-10, the query encoder at 1e-9.
- One ListwiseBert step in float64 (the step of the JAX
  cli/train_listwise.py) against the port's train_listwise step: the
  outputs at 1e-10 and every parameter at 1e-9 after it.
- cli/pretrain_contrastive and cli/train_listwise --tiny --device cpu on a
  synthetic corpus: an epoch line each, finite losses, the queue pointer
  moved by the rows seen, parameters moved, the tokenizer's vocabulary.
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from video_chapter_generation_tpu.core.config import (
    OptimConfig as JaxOptimConfig,
)
from video_chapter_generation_tpu.models import contrastive as jc
from video_chapter_generation_tpu.models.bert import (
    BertConfig as JaxBertConfig,
    BertModel as JaxBertModel,
)
from video_chapter_generation_tpu.train import optim as jax_optim
from video_chapter_generation_tpu.train import objectives as jobj
from video_chapter_generation_tpu_torch.cli import (
    pretrain_contrastive,
    train_listwise,
)
from video_chapter_generation_tpu_torch.core.config import OptimConfig
from video_chapter_generation_tpu_torch.data.synth import (
    make_synth_corpus_on_disk,
)
from video_chapter_generation_tpu_torch.models import convert
from video_chapter_generation_tpu_torch.models.bert import BertConfig
from video_chapter_generation_tpu_torch.models.contrastive import (
    ListwiseBert,
    MoCoTextEncoder,
)
from video_chapter_generation_tpu_torch.train import objectives as obj
from video_chapter_generation_tpu_torch.train.optim import make_optimizer

B, C, L, K = 4, 4, 12, 16
OCFG = dict(learning_rate=1e-3, weight_decay=0.01, grad_norm_clip=0.5)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_info_nce_and_listnet_losses_match_jax():
    rng = np.random.default_rng(0)
    unit = lambda a: a / np.linalg.norm(a, axis=-1, keepdims=True)  # noqa
    q, k = (unit(rng.standard_normal((B, 8))).astype(np.float32)
            for _ in range(2))
    queue = unit(rng.standard_normal((K, 8))).astype(np.float32)
    got = obj.info_nce_loss(*map(torch.from_numpy, (q, k, queue)), 0.07)
    want = jobj.info_nce_loss(q, k, queue, 0.07)
    for name in ("loss", "acc"):
        np.testing.assert_allclose(float(got[1][name]), float(want[1][name]),
                                   rtol=1e-6, atol=1e-6)
    scores = rng.standard_normal((B, 6)).astype(np.float32)
    rel = rng.standard_normal((B, 6)).astype(np.float32)
    aux = rng.standard_normal((B, 6, 2)).astype(np.float32)
    labels = rng.integers(0, 2, (B, 6)).astype(np.int32)
    for extra in ((), (aux, labels)):
        got = obj.listnet_loss(*map(torch.from_numpy, (scores, rel, *extra)),
                               aux_weight=0.5)[1]
        want = jobj.listnet_loss(scores, rel, *extra, aux_weight=0.5)[1]
        assert got.keys() == want.keys()
        for name in want:
            np.testing.assert_allclose(float(got[name]), float(want[name]),
                                       rtol=1e-6, atol=1e-6)


def _to64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


def _shapes(tree):
    return jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)


def _seeded_tree(model, entries, seed):
    """A seeded tree in the JAX layout (convert.random_jax_tree), its
    LayerNorm scales and every bias moved away from 1 and 0."""
    rng = np.random.default_rng(seed + 100)

    def perturb(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                perturb(v)
            elif k in ("scale", "bias"):
                noise = rng.standard_normal(v.shape).astype(np.float32)
                tree[k] = (1 + 0.2 * noise) if k == "scale" else 0.1 * noise
        return tree

    return perturb(convert.random_jax_tree(model, entries, seed=seed))


def _port_layout(tree, entries):
    """A float64 JAX tree in the port's state-dict layout (numpy)."""
    return {key: convert._to_torch_layout(
        np.asarray(convert._get(tree, path), np.float64), kind)
        for path, key, kind in entries}


def _moco_batches(rng, n):
    out = []
    for _ in range(n):
        mask = np.ones((B, L), np.int32)
        mask[1, 7:] = 0
        cmask = np.ones((B, C, L), np.int32)
        cmask[2, 1, 5:] = 0
        out.append({"query_ids": rng.integers(1, 128, (B, L)).astype(np.int32),
                    "query_mask": mask,
                    "cand_ids": rng.integers(1, 128, (B, C, L)).astype(
                        np.int32),
                    "cand_mask": cmask})
    # candidate 2 of row 0 equal to candidate 1: a tie takes the first
    out[0]["cand_ids"][0, 2] = out[0]["cand_ids"][0, 1]
    out[0]["cand_mask"][0, 2] = out[0]["cand_mask"][0, 1]
    return out


def test_moco_steps_match_jax_float64():
    rng = np.random.default_rng(1)
    batches = _moco_batches(rng, 2)
    cfg = JaxBertConfig.tiny()
    enc = jc.MoCoTextEncoder(cfg, K=K)
    # seeded weights (the key encoder apart from the query one) and a
    # seeded unit queue, in the structure of the JAX init_state
    with torch.device("meta"):
        meta = MoCoTextEncoder(BertConfig.tiny(), K=K)
    tree = _seeded_tree(meta, convert.moco_entries(2), 3)
    queue = rng.standard_normal(tree["queue"].shape)
    tree["queue"] = (queue / np.linalg.norm(queue, axis=-1, keepdims=True)
                     ).astype(np.float32)
    state = jc.MoCoState(params_q=tree["params_q"],
                         params_k=tree["params_k"], queue=tree["queue"],
                         queue_ptr=np.zeros((), np.int32))
    assert _shapes(state) == _shapes(jax.eval_shape(
        enc.init_state, jax.random.PRNGKey(0)))
    # the JAX CLI builds its BERT in float32; float64 here on both sides
    enc.model = JaxBertModel(cfg, dtype=jnp.float64)
    port_state = convert.from_jax_moco(state, 2)
    jcfg = JaxOptimConfig(**OCFG)
    want = []
    with jax.enable_x64(True):
        state = state.replace(params_q=_to64(state.params_q),
                              params_k=_to64(state.params_k),
                              queue=_to64(state.queue),
                              # under x64 the update's literal 0 is int64
                              queue_ptr=jnp.asarray(state.queue_ptr,
                                                    jnp.int64))
        tx = jax_optim.make_optimizer(jcfg, state.params_q)
        opt_state = tx.init(state.params_q)

        @jax.jit
        def step(state, opt_state, batch):  # cli/pretrain_contrastive.py
            def loss_fn(params_q):
                s = state.replace(params_q=params_q)
                logits, labels, new_state = enc.forward(
                    s, batch["query_ids"], batch["query_mask"],
                    batch["cand_ids"], batch["cand_mask"])
                loss = optax.softmax_cross_entropy_with_integer_labels(
                    logits, labels).mean()
                return loss, (logits, new_state)

            (loss, (logits, new_state)), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(state.params_q)
            updates, new_opt = tx.update(grads, opt_state, state.params_q)
            params_q = optax.apply_updates(state.params_q, updates)
            return new_state.replace(params_q=params_q), new_opt, loss, \
                logits

        for batch in batches:
            state, opt_state, loss, logits = step(
                state, opt_state, {k: jnp.asarray(v) for k, v in
                                   batch.items()})
            want.append((np.asarray(logits), float(loss),
                         jax.device_get(state)))

    with torch.device("meta"):
        port = MoCoTextEncoder(BertConfig.tiny(), K=K, dtype=torch.float64)
    port.load_state_dict(port_state, assign=True)
    port.double().encoder_k.requires_grad_(False)
    opt = make_optimizer(OptimConfig(**OCFG), port.encoder_q,
                         convert.bert_entries(2))
    tol = dict(rtol=1e-10, atol=1e-10)
    for batch, (logits, loss, st) in zip(batches, want):
        got_loss, _, got_logits = pretrain_contrastive.moco_step(
            port, opt, batch, OCFG["grad_norm_clip"])
        assert np.isfinite(logits).all()
        np.testing.assert_allclose(got_logits.numpy(), logits, **tol)
        np.testing.assert_allclose(got_loss.item(), loss, **tol)
        np.testing.assert_allclose(port.queue.numpy(), np.asarray(st.queue),
                                   **tol)
        assert int(port.queue_ptr) == int(st.queue_ptr)
        sd = port.state_dict()
        for side, t in (("k", tol), ("q", dict(rtol=1e-9, atol=1e-10))):
            for k, w in _port_layout(getattr(st, f"params_{side}"),
                                     convert.bert_entries(2)).items():
                np.testing.assert_allclose(sd[f"encoder_{side}.{k}"].numpy(),
                                           w, err_msg=f"{side} {k}", **t)
    assert int(port.queue_ptr) == 2 * B


def test_listwise_step_matches_jax_float64():
    rng = np.random.default_rng(2)
    s = 6
    mask = np.ones((B, s, L), np.int32)
    mask[0, 3, 4:] = 0
    relevance = np.zeros((B, s), np.float32)
    relevance[np.arange(B), rng.integers(1, s, B)] = 1.0
    batch = {"text_ids": rng.integers(1, 128, (B, s, L)).astype(np.int32),
             "attention_mask": mask, "relevance": relevance,
             "slate_labels": rng.integers(0, 2, (B, s)).astype(np.int32)}
    cfg = JaxBertConfig.tiny()
    lw = jc.ListwiseBert(cfg)
    with torch.device("meta"):
        meta = ListwiseBert(BertConfig.tiny())
    variables = _seeded_tree(meta, convert.listwise_bert_entries(2), 4)
    assert _shapes(variables) == _shapes(jax.eval_shape(
        lw.init_variables, jax.random.PRNGKey(3)))
    lw.model = JaxBertModel(cfg, dtype=jnp.float64)
    import flax.linen as nn

    lw.head = nn.Dense(2, dtype=jnp.float64)
    jcfg = JaxOptimConfig(**OCFG)
    with jax.enable_x64(True):
        params = _to64(variables)
        tx = jax_optim.make_optimizer(jcfg, params)

        @jax.jit
        def step(params, batch):  # cli/train_listwise.py
            def loss_fn(p):
                b, sl, _ = batch["text_ids"].shape
                out = lw.train_forward(
                    p, batch["text_ids"], batch["attention_mask"],
                    batch["relevance"], jnp.arange(b * sl),
                    batch["slate_labels"].reshape(-1))
                return out["loss"], out

            (_, out), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                params)
            updates, _ = tx.update(grads, tx.init(params), params)
            return optax.apply_updates(params, updates), out

        params, out = step(params, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        want = _port_layout(jax.device_get(params),
                            convert.listwise_bert_entries(2))
        out = jax.device_get(out)

    with torch.device("meta"):
        port = ListwiseBert(BertConfig.tiny(), dtype=torch.float64)
    port.load_state_dict(convert.from_jax_listwise_bert(variables, 2),
                         assign=True)
    port.double()
    opt = make_optimizer(OptimConfig(**OCFG), port,
                         convert.listwise_bert_entries(2))
    got = train_listwise.listwise_step(port, opt, batch,
                                       OCFG["grad_norm_clip"])
    for name in ("loss", "surrogate_loss", "binary_loss", "binary_logits"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(out[name]),
                                   rtol=1e-10, atol=1e-10, err_msg=name)
    sd = port.state_dict()
    for k, w in want.items():
        np.testing.assert_allclose(sd[k].numpy(), w, rtol=1e-9, atol=1e-10,
                                   err_msg=k)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_synth_corpus_on_disk(
        str(tmp_path_factory.mktemp("contrastive")), n_videos=4,
        video_sec=60, hw=32, splits={"train": 4})


def _argv(paths, *extra):
    return [f"data.img_dir={paths['img_dir']}",
            f"data.data_file={paths['data_file']}",
            f"data.subtitle_dir={paths['subtitle_dir']}",
            f"data.train_vid_file={paths['train_vid_file']}",
            "data.batch_size=2", "data.max_text_len=16",
            "model.compute_dtype=float32", "train.max_epochs=2", *extra,
            "--tiny", "--device", "cpu"]


def test_pretrain_contrastive_and_train_listwise_clis(corpus, capsys):
    enc = pretrain_contrastive.main(_argv(corpus))
    said = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in said] == ["epoch 0", "epoch 1"]
    assert all(math.isfinite(float(line.split()[3])) for line in said)
    assert enc.K == 256 and int(enc.queue_ptr) == 2 * 4  # 2 epochs x 4 rows
    assert not torch.equal(enc.encoder_q.pooler.dense.weight,
                           enc.encoder_k.pooler.dense.weight)
    # both encoders start equal; the key encoder trails the query one
    moved = enc.encoder_k.pooler.dense.weight - torch.from_numpy(
        enc.init_state(123)["encoder_k.pooler.dense.weight"].numpy())
    assert 0 < moved.abs().max() < 1e-3
    lw = train_listwise.main(_argv(corpus))
    said = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in said] == ["epoch 0", "epoch 1"]
    assert all(math.isfinite(float(line.split()[3])) for line in said)
    assert lw.bert.embeddings.word_embeddings.weight.shape[0] == \
        enc.cfg.vocab_size != 128
