"""The fusion variants (models/fusion_variants.py) on the port against the
JAX package on the CPU.

- DSWindowSelfAttention, DomainSpecificChapterHead,
  SingleBlockWindowClassifier and TwoStreamDomainSpecific's serving
  forward (BERT tiny, ResNet-TSM with stage sizes (1, 1, 1, 1), T = 4,
  32-px frames, W = 3) in float32 at 1e-5, on seeded trees whose
  structure is the JAX modules' own init structure.
- TwoStreamDomainSpecific in float64: the serving forward at 1e-6 (the
  serving trunk folds BatchNorm in float32, as its kernels take it), and
  one training step (batch-statistics BatchNorm, dropout off on both
  sides: JAX deterministic=True, train=True) under the grouped optimizer
  (backbones at the base rate, the head at twice it) against the JAX
  make_grouped_optimizer chain: the loss at 1e-9 relative, every
  parameter and BN statistic at 1e-7 relative plus 1e-10 absolute.
"""

import dataclasses

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
from video_chapter_generation_tpu.models import fusion_variants as jfv
from video_chapter_generation_tpu.models.resnet import ResNet as JaxResNet
from video_chapter_generation_tpu.train import optim as jax_optim
from video_chapter_generation_tpu.train.objectives import (
    clip_classification_loss as jax_clip_loss,
)
from video_chapter_generation_tpu_torch.core.config import OptimConfig
from video_chapter_generation_tpu_torch.models import convert
from video_chapter_generation_tpu_torch.models import fusion_variants as fv
from video_chapter_generation_tpu_torch.models.bert import (
    BertConfig,
    BertModel,
)
from video_chapter_generation_tpu_torch.models.resnet import ResNet
from video_chapter_generation_tpu_torch.train.objectives import (
    clip_classification_loss,
)
from video_chapter_generation_tpu_torch.train.optim import (
    clipped_step,
    make_grouped_optimizer,
)

W, SEG, H, NH, B = 3, 4, 32, 4, 2
LANG, VIS, T, L, HW = 24, 40, 4, 12, 32
SIZES = (1, 1, 1, 1)
TOL32 = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _perturb(tree, rng):
    """Norm and BN affines and statistics away from 1 and 0, in place."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _perturb(v, rng)
        elif k in ("scale", "bias", "mean", "var"):
            noise = rng.standard_normal(v.shape).astype(np.float32)
            tree[k] = (np.abs(1 + 0.2 * noise) if k in ("scale", "var")
                       else 0.1 * noise)
    return tree


def _shapes(tree):
    return jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)


def _module_case(name, rng):
    """(port module, entries, JAX module, inputs) of one small module."""
    lang = rng.standard_normal((B, W, LANG)).astype(np.float32)
    if name == "ds_attention":
        x = rng.standard_normal((B, W, H)).astype(np.float32)
        return (fv.DSWindowSelfAttention(H, NH, 1),
                convert.ds_window_attention_entries(),
                jfv.DSWindowSelfAttention(H, num_heads=NH, window_size=1),
                (x,))
    if name == "ds_head":
        vision = rng.standard_normal((B, W, SEG, VIS)).astype(np.float32)
        return (fv.DomainSpecificChapterHead(W, SEG, H, 1, lang_dim=LANG,
                                             vision_dim=VIS),
                convert.domain_specific_head_entries(),
                jfv.DomainSpecificChapterHead(num_clips=W, segment_size=SEG,
                                              hidden_size=H, window_size=1),
                (lang, vision))
    x = rng.standard_normal((B, W, H)).astype(np.float32)
    return (fv.SingleBlockWindowClassifier(H, NH, 1),
            convert.single_block_window_entries(),
            jfv.SingleBlockWindowClassifier(hidden_size=H, num_heads=NH,
                                            window_size=1),
            (x,))


@pytest.mark.parametrize("name", ["ds_attention", "ds_head", "single_block"])
def test_fusion_variant_module_matches_jax(name):
    rng = np.random.default_rng(0)
    net, entries, jax_net, inputs = _module_case(name, rng)
    tree = _perturb(convert.random_jax_tree(net, entries, seed=1), rng)
    assert _shapes(tree) == _shapes(jax.eval_shape(
        jax_net.init, jax.random.PRNGKey(0), *inputs)["params"])
    want = jax.jit(jax_net.apply)({"params": tree}, *inputs)
    net.load_state_dict(convert.from_jax(tree, entries))
    got = net.eval()(*map(torch.from_numpy, inputs))
    if name == "single_block":
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                       **TOL32)
    else:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **TOL32)


def _no_dropout(cfg):
    return dataclasses.replace(cfg, hidden_dropout=0.0, attention_dropout=0.0)


@pytest.fixture(scope="module")
def ds_tree():
    return _ds_tree(5)


def _ds_tree(seed):
    with torch.device("meta"):
        net = fv.TwoStreamDomainSpecific(
            BertModel(BertConfig.tiny()),
            ResNet(50, n_segment=T, stage_sizes=SIZES), segment_size=T,
            hidden_size=H)
    entries = convert.two_stream_domain_specific_entries(2, SIZES)
    return _perturb(convert.random_jax_tree(net, entries, seed=seed),
                    np.random.default_rng(seed))


def _jax_ds(dtype):
    return jfv.TwoStreamDomainSpecific(
        lang_model=JaxBertModel(_no_dropout(JaxBertConfig.tiny()),
                                dtype=dtype),
        vision_model=JaxResNet(stage_sizes=SIZES, n_segment=T, dtype=dtype),
        window_size=1, segment_size=T, hidden_size=H, dtype=dtype)


def _port_ds(tree, dtype):
    net = fv.TwoStreamDomainSpecific(
        BertModel(_no_dropout(BertConfig.tiny())),
        ResNet(50, n_segment=T, stage_sizes=SIZES, dtype=dtype),
        segment_size=T, hidden_size=H, dtype=dtype, dropout=0.0)
    net.load_state_dict(convert.from_jax_two_stream_domain_specific(
        tree, 2, SIZES))
    return net.to(dtype)


def _batch(rng, dtype=np.float32):
    img = rng.standard_normal((B, W, T, HW, HW, 3)).astype(dtype)
    ids = rng.integers(1, 128, (B, W, L)).astype(np.int32)
    mask = np.ones((B, W, L), np.int32)
    mask[1, 2, 5:] = 0
    return img, ids, mask


def test_two_stream_domain_specific_serving_matches_jax_float32(ds_tree):
    rng = np.random.default_rng(4)
    tree = ds_tree
    img, ids, mask = _batch(rng)
    model = _jax_ds(jnp.float32)
    assert _shapes(tree) == _shapes(jax.eval_shape(
        model.init, jax.random.PRNGKey(0), img, ids, mask))
    logits, probs = jax.jit(model.apply)(tree, img, ids, mask)
    net = _port_ds(tree, torch.float32).eval()
    got_logits, got_probs = net(torch.from_numpy(img),
                                torch.from_numpy(ids).long(),
                                torch.from_numpy(mask))
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(logits),
                               **TOL32)
    np.testing.assert_allclose(got_probs.numpy(), np.asarray(probs), **TOL32)


def test_two_stream_domain_specific_float64_serving_and_training_step(
        ds_tree):
    rng = np.random.default_rng(6)
    tree = ds_tree
    img, ids, mask = _batch(rng, np.float64)
    labels = np.asarray([0, 1], np.int32)
    ocfg = dict(learning_rate=1e-3, weight_decay=0.01, grad_norm_clip=1.0)
    model = _jax_ds(jnp.float64)
    with jax.enable_x64(True):
        to64 = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda a: jnp.asarray(a, jnp.float64), t)
        params, bstats = to64(tree["params"]), to64(tree["batch_stats"])
        tx = jax_optim.make_grouped_optimizer(JaxOptimConfig(**ocfg), params)

        def loss_fn(p):
            (logits, _), mut = model.apply(
                {"params": p, "batch_stats": bstats}, img, ids, mask,
                deterministic=True, train=True, mutable=["batch_stats"])
            return jax_clip_loss(logits, labels)[0], mut["batch_stats"]

        @jax.jit
        def serve_and_step(p):
            serve, _ = model.apply({"params": p, "batch_stats": bstats},
                                   img, ids, mask)
            (loss, stats), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
            upd, _ = tx.update(g, tx.init(p), p)
            return (serve, jax.tree_util.tree_map(lambda a, u: a + u, p, upd),
                    stats, loss)

        serve_logits, params, new_stats, loss = serve_and_step(params)
        want = {}
        for path, key, kind in convert.two_stream_domain_specific_entries(
                2, SIZES):
            leaf = convert._get({"params": params, "batch_stats": new_stats},
                                path)
            want[key] = convert._to_torch_layout(np.asarray(leaf, np.float64),
                                                 kind)
        serve_logits, loss = np.asarray(serve_logits), float(loss)

    net = _port_ds(tree, torch.float64)
    timg, tids, tmask = (torch.from_numpy(img), torch.from_numpy(ids).long(),
                         torch.from_numpy(mask))
    got, _ = net.eval()(timg, tids, tmask)
    # the serving trunk folds BatchNorm in float32 (its kernels' form)
    np.testing.assert_allclose(got.numpy(), serve_logits, rtol=1e-6,
                               atol=1e-6)
    opt = make_grouped_optimizer(
        OptimConfig(**ocfg), net,
        convert.two_stream_domain_specific_entries(2, SIZES))
    net.train()
    logits, _ = net(timg, tids, tmask, train=True)
    got_loss, _ = clip_classification_loss(logits, torch.from_numpy(labels))
    got_loss.backward()
    clipped_step(opt, net.parameters(), ocfg["grad_norm_clip"])
    np.testing.assert_allclose(got_loss.item(), loss, rtol=1e-9)
    sd = net.state_dict()
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(sd[k].detach().numpy(), w, rtol=1e-7,
                                   atol=1e-10 + 1e-7 * scale, err_msg=k)
