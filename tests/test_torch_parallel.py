"""The port's mesh and sharded serving (parallel/mesh.py,
pipeline/sharded.py) against the JAX package's, on the CPU.

- make_mesh over 8 CPU devices (data=-1: 8; model=2: 4 x 2),
  local_batch_size, and shard_params_zero / shard_params_tp picking the
  same dim as the JAX specs on the trees of tests/test_mesh.py and
  tests/test_pipeline_sharded.py:133.
- The sharded text, two-stream (64-px frames) and window scorers on a
  mesh of 4 CPU shards: scores equal bit for bit to the port's unsharded
  scorer run on each shard's rows (the split and the merge add nothing),
  equal to it on the whole batch for the text and window scorers and
  within 1e-6 for the two-stream one (its layer-3 and layer-4 CPU GEMMs
  sum in another order at a quarter of the rows: 1.7e-6 apart in the
  features), and within 1e-5 of the JAX sharded scorer on its 8-device
  mesh (float32; the same models, weights carried across); a batch the
  data axis does not divide raises ValueError.
- shard_title_fn pads and trims (tests/test_pipeline_sharded.py:58-85),
  for both signatures; replicate copies a model; the shard runner keeps
  row order over several devices (one thread a device), and the launch
  counters stay exact under contention.
"""

import sys
import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as P

import video_chapter_generation_tpu.models.resnet as jax_resnet
from fixtures import make_corpus, make_wordpiece
from test_torch_models import _perturb
from video_chapter_generation_tpu.data.clip_grid import (
    flatten_video_to_clips as jax_flatten,
)
from video_chapter_generation_tpu.data.datasets import (
    InferClipDataset as JaxInferClipDataset,
)
from video_chapter_generation_tpu.models.bert import (
    BertConfig as JaxBertConfig,
    BertForChapter as JaxBertForChapter,
    BertModel as JaxBertModel,
)
from video_chapter_generation_tpu.models.fusion import (
    TwoStream as JaxTwoStream,
    TwoStreamWindow as JaxTwoStreamWindow,
)
from video_chapter_generation_tpu.parallel import (
    make_mesh as jax_make_mesh,
    shard_params_tp as jax_shard_params_tp,
    shard_params_zero as jax_shard_params_zero,
)
from video_chapter_generation_tpu.pipeline import (
    make_sharded_text_score_fn as jax_sharded_text,
    make_sharded_two_stream_score_fn as jax_sharded_two_stream,
    make_sharded_window_score_fn as jax_sharded_window,
    score_clips as jax_score_clips,
)
from video_chapter_generation_tpu_torch.models import convert
from video_chapter_generation_tpu_torch.models.bert import (
    BertConfig,
    BertForChapter,
    BertModel,
)
from video_chapter_generation_tpu_torch.models.fusion import (
    TwoStream,
    TwoStreamWindow,
)
from video_chapter_generation_tpu_torch.models.resnet import ResNet
from video_chapter_generation_tpu_torch.ops import _calls
from video_chapter_generation_tpu_torch.parallel import (
    DATA_AXIS,
    MODEL_AXIS,
    batch_sharding,
    local_batch_size,
    local_devices,
    make_mesh,
    replicated,
    shard_batch,
    shard_params_tp,
    shard_params_zero,
    use_mesh,
)
from video_chapter_generation_tpu_torch.parallel.mesh import CPU_SHARDS
from video_chapter_generation_tpu_torch.pipeline import (
    make_sharded_text_score_fn,
    make_sharded_two_stream_score_fn,
    make_sharded_window_score_fn,
    make_text_score_fn,
    make_two_stream_score_fn,
    make_window_score_fn,
    score_clips,
    shard_title_fn,
)
from video_chapter_generation_tpu_torch.pipeline.sharded import (
    _run_shards,
    replicate,
)

CPU = torch.device("cpu")
T, HIDDEN, SIZES, B = 4, 16, (1, 1, 1, 1), 8
TOL = dict(rtol=0, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpu_mesh(n=4, **kw):
    return make_mesh(devices=[CPU] * n, **kw)


# --- the mesh -------------------------------------------------------------


def test_mesh_shapes_and_local_batch():
    mesh = _cpu_mesh(8)
    assert mesh.shape == {DATA_AXIS: 8, MODEL_AXIS: 1}
    assert _cpu_mesh(8, model=2).shape == {DATA_AXIS: 4, MODEL_AXIS: 2}
    assert local_batch_size(32, mesh) == 4
    with pytest.raises(ValueError, match="not divisible"):
        local_batch_size(12, mesh)
    with pytest.raises(ValueError):
        _cpu_mesh(6, model=4)
    parts = shard_batch(_cpu_mesh(4), {"x": np.arange(8).reshape(8, 1)})
    assert [p["x"].flatten().tolist() for p in parts] == [
        [0, 1], [2, 3], [4, 5], [6, 7]]
    # the JAX package's layout names: P("data") splits like shard_batch,
    # P() copies once a distinct device; use_mesh yields the mesh
    by_layout = batch_sharding(_cpu_mesh(4))({"x": np.arange(8)})
    assert [p["x"].tolist() for p in by_layout] == [[0, 1], [2, 3], [4, 5],
                                                    [6, 7]]
    copies = replicated(_cpu_mesh(4))(np.ones(3))
    assert list(copies) == [CPU] and copies[CPU].tolist() == [1, 1, 1]
    with use_mesh(mesh) as m:
        assert m is mesh
    assert local_devices(CPU) == [CPU] * CPU_SHARDS
    assert local_devices("cpu:0") == [torch.device("cpu:0")] * CPU_SHARDS


def _spec_dim(spec, axis):
    """The dim a JAX PartitionSpec shards over `axis`, or None."""
    for i, a in enumerate(spec):
        if a == axis:
            return i
    return None


ZERO_TREE = {"big": (1024, 64), "small": (4,), "odd": (999, 333),
             "wide": (64, 1024), "even": (128, 128), "cube": (8, 16, 24)}
TP_TREE = {"kernel": (64, 64), "odd": (64, 63), "bias": (64,),
           "small": (2, 2), "stack": (3, 64, 32)}


@pytest.mark.parametrize("name", sorted(ZERO_TREE))
def test_shard_params_zero_matches_jax(name):
    tree = {name: np.zeros(ZERO_TREE[name], np.float32)}
    want = jax_shard_params_zero(jax_make_mesh(), tree, min_size=100)[name]
    got = shard_params_zero(_cpu_mesh(8), tree, min_size=100)[name]
    assert got == _spec_dim(want.spec, "data")
    # torch tensors are read by shape too
    assert shard_params_zero(_cpu_mesh(8), {name: torch.zeros(
        ZERO_TREE[name])}, min_size=100)[name] == got


@pytest.mark.parametrize("name", sorted(TP_TREE))
def test_shard_params_tp_matches_jax(name):
    tree = {name: np.zeros(TP_TREE[name], np.float32)}
    want = jax_shard_params_tp(jax_make_mesh(data=4, model=2), tree,
                               min_size=256)[name]
    got = shard_params_tp(_cpu_mesh(8, model=2), tree, min_size=256)[name]
    assert got == _spec_dim(want.spec, "model")
    assert shard_params_tp(_cpu_mesh(8), tree, min_size=256)[name] is None


def test_jax_spec_reader():
    assert _spec_dim(P(None, "model"), "model") == 1 and _spec_dim(P(), "x") \
        is None


# --- sharded scorers ------------------------------------------------------


def _text_models():
    tok = make_wordpiece()
    cfg = JaxBertConfig.tiny(vocab_size=tok.vocab_size)
    jm = JaxBertForChapter(cfg, pretrain_stage=False)
    ids = jnp.ones((1, 16), jnp.int32)
    v = jm.init(jax.random.PRNGKey(0), ids, jnp.ones_like(ids))
    v = _perturb(jax.tree_util.tree_map(np.asarray, v),
                 np.random.default_rng(0))
    net = BertForChapter(BertConfig.tiny(vocab_size=tok.vocab_size),
                         pretrain_stage=False)
    net.load_state_dict(convert.from_jax(
        v, convert.bert_for_chapter_entries(2)))
    return tok, jm, v, net.eval()


def _per_shard(fn, batch, n=4):
    """fn on each of n contiguous row blocks of batch, concatenated."""
    rows = next(iter(batch.values())).shape[0] // n
    return torch.cat([torch.as_tensor(fn({k: v[i * rows:(i + 1) * rows]
                                          for k, v in batch.items()}))
                      for i in range(n)])


def test_sharded_text_scorer_matches_unsharded_and_jax():
    tok, jm, v, net = _text_models()
    corpus = make_corpus(1)
    vid = corpus.vids[0]
    clips = jax_flatten(vid, "", corpus.image_num(vid),
                        corpus.raw_cut_secs(vid), corpus.subtitles(vid), 16)
    ds = JaxInferClipDataset(clips, tok, max_text_len=16, mode="text")
    mesh = _cpu_mesh(4)
    ref = [c.pred_score for c in score_clips(ds, make_text_score_fn(
        net, CPU), batch_size=B)]
    got = [c.pred_score for c in score_clips(ds, make_sharded_text_score_fn(
        net, mesh), batch_size=B)]
    assert got == ref
    batch = {"text_ids": np.stack([ds[i]["text_ids"] for i in range(B)]),
             "attention_mask": np.stack([ds[i]["attention_mask"]
                                         for i in range(B)])}
    assert torch.equal(make_sharded_text_score_fn(net, mesh)(batch),
                       _per_shard(make_text_score_fn(net, CPU), batch))
    jmesh = jax_make_mesh()
    with jmesh:
        want = [c.pred_score for c in jax_score_clips(
            ds, jax_sharded_text(jm, v, jmesh), batch_size=B)]
    np.testing.assert_allclose(got, want, **TOL)
    bad = {"text_ids": np.ones((6, 16), np.int32),
           "attention_mask": np.ones((6, 16), np.int32)}
    with pytest.raises(ValueError, match="not divisible"):
        make_sharded_text_score_fn(net, mesh)(bad)


def _frames(rng, *shape):
    return rng.integers(0, 256, (*shape, 3), dtype=np.uint8)


def _text_batch(rng, *shape):
    ids = rng.integers(1, 128, (*shape, 12)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[..., 9:] = 0
    return ids, mask


def test_sharded_two_stream_scorer_matches_unsharded_and_jax():
    hw = 64
    net = TwoStream(BertModel(BertConfig.tiny()),
                    ResNet(50, n_segment=T, stem_input="frames",
                           stage_sizes=SIZES),
                    segment_size=T, hidden_size=HIDDEN)
    v = _perturb(convert.random_jax_tree(
        net, convert.two_stream_entries(2, SIZES), seed=3),
        np.random.default_rng(3))
    net.load_state_dict(convert.from_jax_two_stream(v, 2, SIZES))
    net.eval()
    jm = JaxTwoStream(
        lang_model=JaxBertModel(JaxBertConfig.tiny()),
        vision_model=jax_resnet.ResNet(stage_sizes=SIZES, n_segment=T),
        segment_size=T, hidden_size=HIDDEN, head_type="mlp")
    rng = np.random.default_rng(4)
    ids, mask = _text_batch(rng, B)
    batch = {"img_clip": _frames(rng, B, T, hw, hw), "text_ids": ids,
             "attention_mask": mask}
    unsharded = make_two_stream_score_fn(net, CPU)
    got = make_sharded_two_stream_score_fn(net, _cpu_mesh(4))(batch)
    assert got.dtype == torch.float32
    assert torch.equal(got, _per_shard(unsharded, batch))
    np.testing.assert_allclose(got.numpy(), unsharded(batch).numpy(),
                               rtol=0, atol=1e-6)
    jmesh = jax_make_mesh()
    with jmesh:
        want = jax_sharded_two_stream(jm, v, jmesh)(batch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="not divisible"):
        make_sharded_two_stream_score_fn(net, _cpu_mesh(3))(batch)


def test_sharded_window_scorer_matches_unsharded_and_jax():
    hw, w = 32, 3
    net = TwoStreamWindow(BertModel(BertConfig.tiny()),
                          ResNet(50, n_segment=T, stage_sizes=SIZES),
                          segment_size=T, hidden_size=HIDDEN)
    v = _perturb(convert.random_jax_tree(
        net, convert.two_stream_window_entries(2, SIZES), seed=5),
        np.random.default_rng(5))
    net.load_state_dict(convert.from_jax_two_stream_window(v, 2, SIZES))
    net.eval()
    jm = JaxTwoStreamWindow(
        lang_model=JaxBertModel(JaxBertConfig.tiny()),
        vision_model=jax_resnet.ResNet(stage_sizes=SIZES, n_segment=T),
        window_size=1, segment_size=T, hidden_size=HIDDEN)
    rng = np.random.default_rng(6)
    ids, mask = _text_batch(rng, B, w)
    batch = {"img_clips": _frames(rng, B, w, T, hw, hw), "text_ids": ids,
             "attention_mask": mask}
    unsharded = make_window_score_fn(net, CPU)
    fn = make_sharded_window_score_fn(net, _cpu_mesh(4))
    got = fn(batch)
    assert fn.model is net and torch.equal(got, unsharded(batch))
    assert torch.equal(got, _per_shard(unsharded, batch))
    jmesh = jax_make_mesh()
    with jmesh:
        want = jax_sharded_window(jm, v, jmesh)(batch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# --- titles, replicas, the shard runner ----------------------------------


@pytest.mark.parametrize("vision", [False, True])
def test_shard_title_fn_pads_and_trims(vision):
    mesh = _cpu_mesh(4)
    calls = []

    def title_fn(ids, mask, *vis):
        calls.append(int(ids.shape[0]))
        out = np.asarray(ids)[:, :4] + np.asarray(mask)[:, :4]
        if vis:
            out = out + np.asarray(vis[1])[:, :4]
        return out

    wrapped = shard_title_fn(title_fn, mesh)
    ids = np.arange(3 * 8, dtype=np.int32).reshape(3, 8)
    mask = np.ones_like(ids)
    extra = (np.zeros((3, 5, 2), np.float32),
             np.full((3, 5), 2, np.int32)) if vision else ()
    out = np.asarray(wrapped(ids, mask, *extra))
    assert calls == [1, 1, 1, 1]  # 3 chapters padded to 4, one a shard
    assert out.shape == (3, 4)
    np.testing.assert_array_equal(out, ids[:, :4] + 1 + 2 * vision)
    calls.clear()
    out = np.asarray(wrapped(np.tile(ids, (3, 1)), np.tile(mask, (3, 1)),
                             *(np.tile(e, (3,) + (1,) * (e.ndim - 1))
                               for e in extra)))
    assert calls == [3, 3, 3, 3] and out.shape == (9, 4)


def test_replicate_copies_a_model():
    _, _, _, net = _text_models()
    twin = replicate(net, CPU)
    assert twin is not net
    for (k, a), (_, b) in zip(net.state_dict().items(),
                              twin.state_dict().items()):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr(), k
    ids = torch.ones(2, 16, dtype=torch.long)
    assert torch.equal(net(ids, torch.ones_like(ids))[1],
                       twin(ids, torch.ones_like(ids))[1])


def test_shard_runner_keeps_row_order_over_devices():
    """Devices alternate shard by shard; each device's shards run in one
    thread, in order, and the outputs come back in shard order."""
    devices = [CPU, torch.device("meta")] * 3
    seen = {}

    def work(d, shard):
        seen.setdefault(d, []).append((shard, threading.get_ident()))
        return shard * 10

    out = _run_shards(devices, work, list(range(6)), lambda v: v)
    assert out == [0, 10, 20, 30, 40, 50]
    assert [s for s, _ in seen[CPU]] == [0, 2, 4]
    assert [s for s, _ in seen[torch.device("meta")]] == [1, 3, 5]
    assert len({t for _, t in seen[CPU]}) == 1


def test_launch_counters_exact_under_threads():
    def wrapper():
        pass

    wrapper.launches = 0
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            _calls.count(wrapper) for _ in range(2000)]) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == 16 * 2000
