"""The PyTorch port's models against the JAX package on the CPU.

Each case draws one seeded tree in the JAX layout (random kernels; norm
and BatchNorm affines and statistics perturbed so that BN folding is
exercised), runs it through the JAX model, carries it into the port with
models/convert.py, and runs the same numpy inputs there, in float32.
test_random_trees_have_the_jax_layout pins the drawn trees to the JAX
models' own init structure. Tolerances: 1e-4 absolute and relative for
the vision trunk (dozens of convolutions summed in different orders),
1e-5 for the transformer stacks (matmuls and softmaxes only); greedy ids
are equal.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import video_chapter_generation_tpu.models.resnet as jax_resnet
from video_chapter_generation_tpu.models.bert import (
    BertConfig as JaxBertConfig,
    BertModel as JaxBertModel,
    convert_hf_bert,
)
from video_chapter_generation_tpu.models.convert_reference import (
    convert_base_chapter_head,
)
from video_chapter_generation_tpu.models.fusion import (
    ChapterHead as JaxChapterHead,
    TwoStream as JaxTwoStream,
)
from video_chapter_generation_tpu.models.seq2seq import (
    Seq2Seq as JaxSeq2Seq,
    Seq2SeqConfig as JaxSeq2SeqConfig,
    convert_hf_seq2seq,
    generate as jax_generate,
)
from video_chapter_generation_tpu_torch.models import convert
from video_chapter_generation_tpu_torch.models.bert import BertConfig, BertModel
from video_chapter_generation_tpu_torch.models.fusion import (
    ChapterHead,
    TwoStream,
)
from video_chapter_generation_tpu_torch.models.resnet import ResNet, Resnet50TSM
from video_chapter_generation_tpu_torch.models.seq2seq import (
    Seq2Seq,
    Seq2SeqConfig,
    generate,
    trim_at_eos,
)

T, B = 4, 2
SIZES = (2, 2, 2, 2)
TRUNK_TOL = dict(rtol=1e-4, atol=1e-4)
TF_TOL = dict(rtol=1e-5, atol=1e-5)


def _perturb(tree, rng, leaves=("scale", "bias", "mean", "var")):
    """Random norm/BN affines and statistics (var > 0), in place."""
    def walk(node):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v)
            elif k in leaves:
                noise = rng.standard_normal(v.shape).astype(np.float32)
                node[k] = (np.abs(1 + 0.2 * noise) if k in ("scale", "var")
                           else 0.1 * noise)
    walk(tree)
    return tree


def _frames(rng, n):
    return rng.integers(0, 256, (n, 16, 16, 48), np.uint8)  # 64-px s2d


def _port_resnet(variables=None):
    net = ResNet(50, n_segment=T, stem_input="s2d", stage_sizes=SIZES)
    if variables is not None:
        net.load_state_dict(convert.from_jax_resnet(variables, SIZES))
    return net.eval()


@pytest.fixture(scope="module")
def resnet_case():
    rng = np.random.default_rng(0)
    s4 = _frames(rng, B * T)
    m = jax_resnet.ResNet(stage_sizes=SIZES, n_segment=T, stem_input="s2d")
    v = convert.random_jax_tree(_port_resnet(), convert.resnet_entries(SIZES))
    return m, _perturb(v, rng), s4


@pytest.mark.parametrize("whole_blocks", [False, True], ids=["xla", "pallas"])
def test_resnet_matches_jax(resnet_case, whole_blocks, monkeypatch):
    """XLA path, and the Pallas stem + whole-block kernels in interpret
    mode (planar stride-2 links included) on the JAX side."""
    m, v, s4 = resnet_case
    monkeypatch.setattr(jax_resnet, "FORCE_WHOLE_BLOCKS", whole_blocks)
    want = np.asarray(jax.jit(lambda v_, x: m.apply(v_, x, train=False))(
        v, jnp.asarray(s4)))
    got = _port_resnet(v)(torch.from_numpy(s4))
    assert got.shape == (B * T, 2048)
    np.testing.assert_allclose(got.numpy(), want, **TRUNK_TOL)


def test_resnet_frames_stem_matches_jax(resnet_case):
    """stem_input='frames': normalized float frames [N, 64, 64, 3] through
    the stem's plain version (a CUDA tensor launches kernel K8; a tensor
    on any other device is refused)."""
    from video_chapter_generation_tpu_torch.ops.preprocess import (
        depth_to_space4,
        normalize_frames,
    )

    _, v, s4 = resnet_case
    frames = normalize_frames(depth_to_space4(torch.from_numpy(s4)))
    m = jax_resnet.ResNet(stage_sizes=SIZES, n_segment=T)
    want = jax.jit(lambda v_, x: m.apply(v_, x, train=False))(
        v, jnp.asarray(frames.numpy()))
    net = ResNet(50, n_segment=T, stem_input="frames",
                 stage_sizes=SIZES).eval()
    net.load_state_dict(convert.from_jax_resnet(v, SIZES))
    np.testing.assert_allclose(net(frames).numpy(), np.asarray(want),
                               **TRUNK_TOL)
    with pytest.raises(NotImplementedError):
        net(frames.to("meta"))


def test_resnet50tsm_features_shape(resnet_case):
    _, v, s4 = resnet_case
    emb = Resnet50TSM(T, stem_input="s2d", stage_sizes=SIZES).eval()
    emb.base_model.load_state_dict(convert.from_jax_resnet(v, SIZES))
    feats = emb.features(torch.from_numpy(s4).reshape(B, T, 16, 16, 48))
    np.testing.assert_allclose(
        feats.reshape(B * T, -1).numpy(),
        _port_resnet(v)(torch.from_numpy(s4)).numpy(), rtol=0, atol=0)


def test_resnet_state_dict_round_trips_to_jax(resnet_case):
    """Port state dict -> the JAX package's convert_torchvision_resnet50
    -> the JAX tree it came from."""
    _, v, _ = resnet_case
    back = jax_resnet.convert_torchvision_resnet50(
        _port_resnet(v).state_dict())
    flat = lambda t: dict(jax.tree_util.tree_leaves_with_path(t))  # noqa: E731
    got, want = flat(back), flat(v)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k])


def test_bert_matches_jax():
    rng = np.random.default_rng(1)
    bert = BertModel(BertConfig.tiny()).eval()
    p = _perturb(convert.random_jax_tree(bert, convert.bert_entries(2),
                                         seed=1), rng)
    ids = rng.integers(1, bert.cfg.vocab_size, (B, 12)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 8:] = 0
    m = JaxBertModel(JaxBertConfig.tiny())
    want_h, want_p = jax.jit(m.apply)({"params": p}, jnp.asarray(ids),
                                      jnp.asarray(mask))
    bert.load_state_dict(convert.from_jax_bert(p, 2))
    with torch.no_grad():
        got_h, got_p = bert(torch.from_numpy(ids).long(),
                            torch.from_numpy(mask))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **TF_TOL)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), **TF_TOL)
    # the port's keys are HuggingFace's: the JAX converter reads them back
    back = convert_hf_bert(bert.state_dict())["params"]
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(back),
            jax.tree_util.tree_leaves_with_path(p)):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(path))


def jax_two_stream(hidden=16):
    return JaxTwoStream(
        lang_model=JaxBertModel(JaxBertConfig.tiny()),
        vision_model=jax_resnet.ResNet(stage_sizes=SIZES, n_segment=T,
                                       stem_input="s2d"),
        segment_size=T, hidden_size=hidden, head_type="mlp")


def port_two_stream(variables=None, hidden=16):
    """The port's tiny TwoStream, loaded from JAX variables if given."""
    net = TwoStream(BertModel(BertConfig.tiny()),
                    ResNet(50, n_segment=T, stem_input="s2d",
                           stage_sizes=SIZES),
                    segment_size=T, hidden_size=hidden)
    if variables is not None:
        net.load_state_dict(convert.from_jax_two_stream(variables, 2, SIZES))
    return net.eval()


def random_two_stream_variables(seed, hidden=16):
    """A seeded tiny TwoStream tree in the JAX layout."""
    tree = convert.random_jax_tree(port_two_stream(hidden=hidden),
                                   convert.two_stream_entries(2, SIZES),
                                   seed=seed)
    return _perturb(tree, np.random.default_rng(seed))


def test_two_stream_and_head_match_jax():
    rng = np.random.default_rng(2)
    jm, v = jax_two_stream(), random_two_stream_variables(2)
    img = _frames(rng, B * T).reshape(B, T, 16, 16, 48)
    ids = rng.integers(1, 128, (B, 10)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 6:] = 0
    want_logits, want_prob = jax.jit(jm.apply)(
        v, jnp.asarray(img), jnp.asarray(ids), jnp.asarray(mask))
    net = port_two_stream(v)
    logits, prob = net(torch.from_numpy(img), torch.from_numpy(ids).long(),
                       torch.from_numpy(mask))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               **TRUNK_TOL)
    np.testing.assert_allclose(prob.numpy(), np.asarray(want_prob),
                               **TRUNK_TOL)
    # the head alone, carried over from its own subtree
    head = ChapterHead(T, 16, lang_dim=32).eval()
    head.load_state_dict(convert.from_jax_chapter_head(
        v["params"]["fusion_head"]))
    pooled = rng.standard_normal((B, 32)).astype(np.float32)
    vis = rng.standard_normal((B, T, 2048)).astype(np.float32)
    want = jax.jit(JaxChapterHead(T, 16).apply)(
        {"params": v["params"]["fusion_head"]}, jnp.asarray(pooled),
        jnp.asarray(vis))
    with torch.no_grad():
        got = head(torch.from_numpy(pooled), torch.from_numpy(vis))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TF_TOL)
    # the head's keys are the reference two_stream.py's
    head_sd = {k: v_.numpy() for k, v_ in net.fusion_head.state_dict().items()}
    back = convert_base_chapter_head(head_sd)
    np.testing.assert_array_equal(back["head"]["kernel"],
                                  v["params"]["fusion_head"]["head"]["kernel"])


@pytest.fixture(scope="module")
def s2s_case():
    rng = np.random.default_rng(3)
    m = JaxSeq2Seq(JaxSeq2SeqConfig.tiny())
    net = Seq2Seq(Seq2SeqConfig.tiny()).eval()
    p = _perturb(convert.random_jax_tree(
        net, convert.seq2seq_entries(net.cfg), seed=3), rng)
    p["final_logits_bias"] = (rng.standard_normal(net.cfg.vocab_size)
                              .astype(np.float32))
    ids = rng.integers(2, net.cfg.vocab_size, (B, 16)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[0, 11:] = 0
    net.load_state_dict(convert.from_jax_seq2seq(p, net.cfg))
    return m, {"params": p}, net, ids, mask


def test_seq2seq_encode_and_decode_step_match_jax(s2s_case):
    m, v, net, ids, mask = s2s_case
    enc = jax.jit(lambda v_, i, k: m.apply(v_, i, k, method=m.encode))(
        v, jnp.asarray(ids), jnp.asarray(mask))
    t_ids, t_mask = torch.from_numpy(ids).long(), torch.from_numpy(mask)
    got_enc = net.encode(t_ids, t_mask)
    np.testing.assert_allclose(got_enc.numpy(), np.asarray(enc), **TF_TOL)

    max_len = 6
    cache = jax.jit(lambda v_, e: m.apply(v_, B, max_len, e,
                                          method=m.init_cache))(v, enc)
    step = jax.jit(lambda v_, *a: m.apply(v_, *a, max_len=max_len,
                                          method=m.decode_step))
    t_cache = net.init_cache(B, max_len, got_enc)
    tok = np.array([[0], [5]], np.int32)
    for pos in range(3):  # three steps: the self caches fill as they go
        logits, cache = step(v, jnp.asarray(tok), jnp.int32(pos), cache, enc,
                             jnp.asarray(mask))
        t_logits, t_cache = net.decode_step(torch.from_numpy(tok).long(),
                                            pos, t_cache, t_mask, max_len)
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(logits),
                                   **TF_TOL)
        tok = np.asarray(logits).argmax(-1)[:, None].astype(np.int32)


def test_generate_greedy_ids_equal_jax(s2s_case):
    m, v, net, ids, mask = s2s_case
    want, _ = jax.jit(lambda v_, i, k: jax_generate(
        m, v_, i, k, max_len=10, return_logits=False))(
            v, jnp.asarray(ids), jnp.asarray(mask))
    got = generate(net, torch.from_numpy(ids).long(),
                   torch.from_numpy(mask), max_len=10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rows = trim_at_eos(got.numpy(), net.cfg.eos_token_id)
    assert all(len(r) <= 10 for r in rows)


def test_seq2seq_state_dict_round_trips_to_jax(s2s_case):
    m, v, net, _, _ = s2s_case
    back = convert_hf_seq2seq(net.state_dict(), m.cfg)["params"]
    want = dict(jax.tree_util.tree_leaves_with_path(v["params"]))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k])


def test_random_trees_have_the_jax_layout():
    """random_jax_tree (the tests' weights here and the full-width chip
    run's) yields exactly the JAX models' init tree: paths and shapes."""
    shapes = lambda t: jax.tree_util.tree_map(np.shape, t)  # noqa: E731
    jm = jax_two_stream()
    img = jnp.zeros((1, T, 16, 16, 48), jnp.uint8)
    ids = jnp.ones((1, 10), jnp.int32)
    want = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), img, ids,
                                          ids))
    assert shapes(random_two_stream_variables(0)) == jax.tree_util.tree_map(
        lambda a: a.shape, want)
    cfg = Seq2SeqConfig.tiny()
    m = JaxSeq2Seq(JaxSeq2SeqConfig.tiny())
    want = jax.eval_shape(lambda: m.init(jax.random.PRNGKey(0), ids, ids,
                                         ids[:, :2]))["params"]
    tree = convert.random_jax_tree(Seq2Seq(cfg), convert.seq2seq_entries(cfg))
    assert shapes(tree) == jax.tree_util.tree_map(lambda a: a.shape, want)
