"""Grad-CAM, saliency and integrated gradients on the port against the JAX
package's visualization/interpret.py on the CPU, float32 at 1e-5.

- grad_cam_vision on ResNet-TSM (stage sizes (1, 1, 1, 1), T = 4, 32-px
  frames, tsm_impl "xla" in both packages) at the last stage (the
  re-entry is the pool) and at stage 3 (the re-entry runs layer 4's
  block, differentiated), with and without a linear head; the ResNet
  re-entry itself (from_stage) and its capture against the JAX ones.
- saliency_lang and integrated_gradients_lang (16 steps) on the tiny
  BertForChapter, through BertModel's input_embeds.
- The guard every inference kernel wrapper runs on a CUDA input
  (ops/_calls.py:refuse_grad) raises where autograd would need a gradient
  and names the differentiable tsm_impl values; the frame strip and
  thumbnails (visualization/frames.py) equal the JAX package's.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from video_chapter_generation_tpu.models.bert import (
    BertConfig as JaxBertConfig,
    BertForChapter as JaxBertForChapter,
)
from video_chapter_generation_tpu.models.resnet import ResNet as JaxResNet
from video_chapter_generation_tpu.visualization import interpret as ji
from video_chapter_generation_tpu_torch.models import convert
from video_chapter_generation_tpu_torch.models.bert import (
    BertConfig,
    BertForChapter,
)
from video_chapter_generation_tpu_torch.models.resnet import ResNet
from video_chapter_generation_tpu_torch.ops import _calls
from video_chapter_generation_tpu_torch.visualization import interpret

T, HW, N = 4, 32, 8
SIZES = (1, 1, 1, 1)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _perturb(tree, rng):
    for k, v in tree.items():
        if isinstance(v, dict):
            _perturb(v, rng)
        elif k in ("scale", "bias", "mean", "var"):
            noise = rng.standard_normal(v.shape).astype(np.float32)
            tree[k] = (np.abs(1 + 0.2 * noise) if k in ("scale", "var")
                       else 0.1 * noise)
    return tree


@pytest.fixture(scope="module")
def vision():
    """(port ResNet, JAX ResNet, its variables, frames, head weight)."""
    rng = np.random.default_rng(0)
    with torch.device("meta"):
        meta = ResNet(50, n_segment=T, stage_sizes=SIZES)
    entries = convert.resnet_entries(SIZES)
    tree = _perturb(convert.random_jax_tree(meta, entries, seed=1), rng)
    net = ResNet(50, n_segment=T, stage_sizes=SIZES, tsm_impl="xla").eval()
    net.load_state_dict(convert.from_jax_resnet(tree, SIZES))
    jnet = JaxResNet(stage_sizes=SIZES, n_segment=T, tsm_impl="xla")
    frames = rng.standard_normal((N, HW, HW, 3)).astype(np.float32)
    head = (0.05 * rng.standard_normal((2048, 2))).astype(np.float32)
    return net, jnet, tree, frames, head


def test_resnet_capture_and_reentry_match_jax(vision):
    net, jnet, tree, frames, _ = vision
    def jax_capture(tree, frames):
        c = {}
        return jnet.apply(tree, frames, capture=c), c

    cap = {}
    got = net(torch.from_numpy(frames), capture=cap)
    want, jcap = jax.jit(jax_capture)(tree, frames)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for k in ("stage1", "stage2", "stage3", "stage4"):
        np.testing.assert_allclose(cap[k].numpy(), np.asarray(jcap[k]),
                                   err_msg=k, **TOL)
    act = cap["stage2"].clone().requires_grad_()
    out = net(act, from_stage=2)
    assert out.requires_grad  # the re-entry follows the caller's grad mode
    np.testing.assert_allclose(
        out.detach().numpy(),
        np.asarray(jax.jit(lambda t, a: jnet.apply(t, a, from_stage=2))(
            tree, jcap["stage2"])), **TOL)
    with pytest.raises(ValueError):
        net.train()(act, from_stage=2)
    net.eval()


@pytest.mark.parametrize("stage,with_head", [(4, False), (4, True),
                                             (3, True)])
def test_grad_cam_matches_jax(vision, stage, with_head):
    net, jnet, tree, frames, head = vision
    th = torch.from_numpy(head)
    got = interpret.grad_cam_vision(
        net, torch.from_numpy(frames), class_index=1, stage=stage,
        head_fn=(lambda p: p @ th) if with_head else None)
    want = jax.jit(lambda t, f: ji.grad_cam_vision(
        jnet, t, f, class_index=1, stage=stage,
        head_fn=(lambda p: p @ head) if with_head else None))(tree, frames)
    assert got.shape == want.shape == (N, HW // 2 ** (stage + 1),
                                       HW // 2 ** (stage + 1))
    assert float(got.min()) >= 0 and float(got.max()) <= 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def lang():
    rng = np.random.default_rng(2)
    with torch.device("meta"):
        meta = BertForChapter(BertConfig.tiny())
    entries = convert.bert_for_chapter_entries(2)
    tree = _perturb(convert.random_jax_tree(meta, entries, seed=3), rng)
    net = BertForChapter(BertConfig.tiny()).eval()
    net.load_state_dict(convert.from_jax(tree, entries))
    ids = rng.integers(1, 128, (3, 12)).astype(np.int32)
    mask = np.ones((3, 12), np.int32)
    mask[1, 6:] = 0
    mask[2, 9:] = 0
    return net, JaxBertForChapter(JaxBertConfig.tiny()), tree, ids, mask


@pytest.mark.parametrize("fn", ["saliency_lang", "integrated_gradients_lang"])
def test_language_attributions_match_jax(lang, fn):
    net, jnet, tree, ids, mask = lang
    got = getattr(interpret, fn)(net, torch.from_numpy(ids).long(),
                                 torch.from_numpy(mask), class_index=1)
    want = jax.jit(lambda t, i, m: getattr(ji, fn)(jnet, t, i, m,
                                                   class_index=1))(
        tree, jnp.asarray(ids), jnp.asarray(mask))
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, rtol=1e-5)
    assert float(got[1, 6:].abs().max()) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_refuse_grad_names_the_differentiable_routes():
    x = torch.zeros(2, requires_grad=True)
    _calls.refuse_grad("tsm_bottleneck", x.detach())
    with torch.no_grad():
        _calls.refuse_grad("tsm_bottleneck", x)
    with pytest.raises(NotImplementedError, match="'tap3' or 'xla'"):
        _calls.refuse_grad("tsm_bottleneck", x)


def test_frame_strip_matches_jax(tmp_path):
    from video_chapter_generation_tpu.visualization import frames as jframes
    from video_chapter_generation_tpu_torch.data import corpus, synth
    from video_chapter_generation_tpu_torch.visualization import frames

    paths = synth.make_synth_corpus_on_disk(
        str(tmp_path), n_videos=1, video_sec=30, hw=32, splits={"train": 1})
    c = corpus.VideoCorpus.from_files(paths["img_dir"], paths["data_file"],
                                      paths["train_vid_file"],
                                      paths["subtitle_dir"])
    vid = c.vids[0]
    thumbs = frames.video_thumbnails(c, vid, hw=16)
    np.testing.assert_array_equal(thumbs,
                                  jframes.video_thumbnails(c, vid, hw=16))
    kw = dict(row_image_num=7, tolerance=2, pred_timestamps=[5, 12])
    a = frames.chapter_frame_strip(thumbs, [4, 15], **kw)
    b = jframes.chapter_frame_strip(thumbs, [4, 15], **kw)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
