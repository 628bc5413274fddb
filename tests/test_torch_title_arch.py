"""The port's BigBird-Pegasus and BART title models against the JAX
package on the CPU, in float32, and the inference CLI serving them.

Each family's tiny config comes from the two CLIs' `title_s2s_config`
(the port's must equal the JAX one field by field). One seeded tree in
the JAX layout goes through the JAX `Seq2Seq` and, carried over by
models/convert.py, through the port; the port's state dict reads back
through the JAX package's own `convert_hf_seq2seq`. The tiny BigBird
runs at 128 tokens, 8 blocks of 16 with 1 random block, so its encoder
takes the block-sparse path (K10's plain version here). Tolerance 1e-5
for encoder states and logits (matmuls and softmaxes in other orders);
greedy ids are equal.
"""

import dataclasses
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_models import T, _perturb, jax_two_stream, port_two_stream
from test_torch_pipeline import BATCH, BUCKET, CPU, HW, TEXT_LEN, _decode
from test_torch_pipeline import slice_case  # noqa: F401  (a fixture)
from video_chapter_generation_tpu.cli.common import (
    title_s2s_config as jax_title_s2s_config,
)
from video_chapter_generation_tpu.models.seq2seq import (
    Seq2Seq as JaxSeq2Seq,
    convert_hf_seq2seq,
    generate as jax_generate,
)
from video_chapter_generation_tpu.ops.quantize import (
    quantize_seq2seq as jax_quantize_seq2seq,
)
from video_chapter_generation_tpu.pipeline import (
    ChapterPipeline as JaxChapterPipeline,
    bucket_title_fn as jax_bucket_title_fn,
    make_packed_two_stream_score_fn as jax_packed_score_fn,
)
from video_chapter_generation_tpu_torch.cli import infer_video
from video_chapter_generation_tpu_torch.cli.common import title_s2s_config
from video_chapter_generation_tpu_torch.core.contract import ContractMismatch
from video_chapter_generation_tpu_torch.device import resolve_device
from video_chapter_generation_tpu_torch.models import convert
from video_chapter_generation_tpu_torch.models.seq2seq import (
    Seq2Seq,
    Seq2SeqConfig,
    generate,
)
from video_chapter_generation_tpu_torch.ops import sparse_attention as sa_ops
from video_chapter_generation_tpu_torch.ops.quantize import quantize_seq2seq
from video_chapter_generation_tpu_torch.pipeline import (
    ChapterPipeline,
    bucket_title_fn,
    make_packed_two_stream_score_fn,
)

TF_TOL = dict(rtol=1e-5, atol=1e-5)
VOCAB, B, L_IN = 96, 2, 128
ARCHS = ["bigbird", "bart"]
# title input length per family: the tiny BigBird is sparse from 128; the
# tiny BART has 64 positions
IN_LEN = {"bigbird": L_IN, "bart": 64}


def _cfgs(arch, tiny=True, vocab=VOCAB):
    args = SimpleNamespace(tiny=tiny, title_arch=arch)
    tok = SimpleNamespace(vocab_size=vocab)
    return title_s2s_config(args, tok), jax_title_s2s_config(args, tok)


@pytest.mark.parametrize("arch", ["pegasus", "bigbird", "bart"])
@pytest.mark.parametrize("tiny", [True, False])
def test_title_configs_equal_jax(arch, tiny):
    cfg, jcfg = _cfgs(arch, tiny, vocab=8000)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    if arch == "bigbird":
        assert cfg.encoder_attention == "block_sparse"
        assert not cfg.attention_bias and cfg.learned_positions


def _case(arch, seed):
    cfg, jcfg = _cfgs(arch)
    rng = np.random.default_rng(seed)
    net = Seq2Seq(cfg).eval()
    p = _perturb(convert.random_jax_tree(
        net, convert.seq2seq_entries(cfg), seed=seed), rng)
    p["final_logits_bias"] = rng.standard_normal(VOCAB).astype(np.float32)
    net.load_state_dict(convert.from_jax_seq2seq(p, cfg))
    ids = rng.integers(3, VOCAB, (B, IN_LEN[arch])).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 40:] = 0
    return arch, JaxSeq2Seq(jcfg), {"params": p}, net, ids, mask


@pytest.fixture(scope="module", params=ARCHS)
def arch_case(request):
    return _case(request.param, 11)


def test_encode_and_decode_step_match_jax(arch_case, monkeypatch):
    arch, m, v, net, ids, mask = arch_case
    calls = []
    plain = sa_ops.sparse_band_attention_reference
    monkeypatch.setattr(sa_ops, "sparse_band_attention_reference",
                        lambda *a: calls.append(1) or plain(*a))
    enc = jax.jit(lambda v_, i, k: m.apply(v_, i, k, method=m.encode))(
        v, jnp.asarray(ids), jnp.asarray(mask))
    t_ids, t_mask = torch.from_numpy(ids).long(), torch.from_numpy(mask)
    got_enc = net.encode(t_ids, t_mask)
    np.testing.assert_allclose(got_enc.numpy(), np.asarray(enc), **TF_TOL)
    # BigBird's encoder layers each take the sparse band path once
    assert len(calls) == (net.cfg.encoder_layers if arch == "bigbird" else 0)

    max_len = 6
    cache = jax.jit(lambda v_, e: m.apply(v_, B, max_len, e,
                                          method=m.init_cache))(v, enc)
    step = jax.jit(lambda v_, *a: m.apply(v_, *a, max_len=max_len,
                                          method=m.decode_step))
    t_cache = net.init_cache(B, max_len, got_enc)
    tok = np.full((B, 1), net.cfg.decoder_start_token_id, np.int32)
    for pos in range(3):
        logits, cache = step(v, jnp.asarray(tok), jnp.int32(pos), cache, enc,
                             jnp.asarray(mask))
        t_logits, t_cache = net.decode_step(torch.from_numpy(tok).long(),
                                            pos, t_cache, t_mask, max_len)
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(logits),
                                   **TF_TOL)
        tok = np.asarray(logits).argmax(-1)[:, None].astype(np.int32)


def test_encode_matches_the_jax_pallas_kernel():
    """The tiny BigBird's encoder against the JAX model whose sparse
    layers run the Pallas kernel K10 in interpret mode."""
    cfg, jcfg = _cfgs("bigbird")
    rng = np.random.default_rng(12)
    net = Seq2Seq(cfg).eval()
    p = _perturb(convert.random_jax_tree(
        net, convert.seq2seq_entries(cfg), seed=12), rng)
    net.load_state_dict(convert.from_jax_seq2seq(p, cfg))
    ids = rng.integers(3, VOCAB, (B, L_IN)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[0, 100:] = 0
    m = JaxSeq2Seq(dataclasses.replace(jcfg, sparse_impl="kernel"))
    enc = m.apply({"params": p}, jnp.asarray(ids), jnp.asarray(mask),
                  method=m.encode)
    got = net.encode(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(enc), **TF_TOL)


def test_generate_greedy_ids_equal_jax(arch_case):
    _, m, v, net, ids, mask = arch_case
    want, _ = jax.jit(lambda v_, i, k: jax_generate(
        m, v_, i, k, max_len=10, return_logits=False))(
            v, jnp.asarray(ids), jnp.asarray(mask))
    got = generate(net, torch.from_numpy(ids).long(),
                   torch.from_numpy(mask), max_len=10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_state_dict_round_trips_to_jax(arch_case):
    """convert_hf_seq2seq reads the port's state dict as it is: the same
    tree back, no bias entries for BigBird's attention, the position
    tables and BART's embedding LayerNorms included."""
    arch, m, v, net, _, _ = arch_case
    sd = net.state_dict()
    assert ("model.encoder.layers.0.self_attn.q_proj.bias" in sd) == (
        arch == "bart")
    assert "model.decoder.embed_positions.weight" in sd
    assert ("model.encoder.layernorm_embedding.weight" in sd) == (
        arch == "bart")
    assert ("model.encoder.layer_norm.weight" in sd) == (arch == "bigbird")
    back = convert_hf_seq2seq(sd, m.cfg)["params"]
    want = dict(jax.tree_util.tree_leaves_with_path(v["params"]))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_random_trees_have_the_jax_layout(arch):
    cfg, jcfg = _cfgs(arch)
    ids = jnp.ones((1, 16), jnp.int32)
    m = JaxSeq2Seq(jcfg)
    want = jax.eval_shape(lambda: m.init(jax.random.PRNGKey(0), ids, ids,
                                         ids[:, :2]))["params"]
    tree = convert.random_jax_tree(Seq2Seq(cfg), convert.seq2seq_entries(cfg))
    shapes = jax.tree_util.tree_map(np.shape, tree)
    assert shapes == jax.tree_util.tree_map(lambda a: a.shape, want)


def test_int8_bigbird_generate_matches_jax():
    _, _, v, net, ids, mask = _case("bigbird", 13)
    cfg, jcfg = _cfgs("bigbird")
    qcfg = dataclasses.replace(cfg, weight_quant=True, kv_quant=True)
    jv = jax_quantize_seq2seq(v)
    jm = JaxSeq2Seq(dataclasses.replace(jcfg, weight_quant=True,
                                        kv_quant=True))
    want, _ = jax.jit(lambda v_, i, k: jax_generate(
        jm, v_, i, k, max_len=10, return_logits=False))(
            jv, jnp.asarray(ids), jnp.asarray(mask))
    sd = quantize_seq2seq(net.state_dict())
    carried = convert.from_jax_seq2seq(jv["params"], qcfg)
    assert sd.keys() == carried.keys()
    for k in sd:
        assert sd[k].dtype == carried[k].dtype and torch.equal(
            sd[k], carried[k]), k
    assert sd["model.encoder.embed_positions.weight"].dtype == torch.float32
    qnet = Seq2Seq(qcfg).eval()
    qnet.load_state_dict(sd)
    got = generate(qnet, torch.from_numpy(ids).long(), torch.from_numpy(mask),
                   max_len=10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_packed_pipeline_titles_match_jax(slice_case, arch,  # noqa: F811
                                          monkeypatch):
    """The packed ChapterPipeline (frame pack, bucketed titles) serving the
    family's tiny title model gives the JAX pipeline's cut points and
    title id rows."""
    from fixtures import make_unigram, make_wordpiece

    corpus, variables, _, _ = slice_case
    _, m, v, net, _, _ = _case(arch, 14)
    calls = []
    plain = sa_ops.sparse_band_attention_reference
    monkeypatch.setattr(sa_ops, "sparse_band_attention_reference",
                        lambda *a: calls.append(1) or plain(*a))
    kw = dict(clip_frame_num=T, max_text_len=TEXT_LEN,
              title_input_len=IN_LEN[arch], batch_size=BATCH,
              score_mode="all", hw=HW, frame_pack=True)

    def title_fn(ids, mask):
        return generate(net, torch.from_numpy(ids).long(),
                        torch.from_numpy(mask), max_len=6).numpy()

    port = ChapterPipeline(
        corpus, make_wordpiece(),
        make_packed_two_stream_score_fn(port_two_stream(variables), CPU),
        bucket_title_fn(title_fn, BUCKET), _decode,
        title_tokenizer=make_unigram(), device=CPU, **kw)
    titles = jax.jit(lambda v_, i, k: jax_generate(
        m, v_, i, k, max_len=6, return_logits=False)[0])
    ref = JaxChapterPipeline(
        corpus, make_wordpiece(),
        jax_packed_score_fn(jax_two_stream(), variables),
        jax_bucket_title_fn(lambda i, k: titles(v, jnp.asarray(i),
                                                jnp.asarray(k)), BUCKET),
        _decode, title_tokenizer=make_unigram(), **kw)
    vid = corpus.vids[0]
    got = port.run(pipelined=True)[vid]
    want = ref.run(pipelined=True)[vid]
    assert got.cut_points and got.cut_points == want.cut_points
    assert len(got.titles) == len(got.spans)
    assert got.titles == want.titles
    batches = -(-len(got.spans) // BUCKET)
    assert len(calls) == (2 * batches if arch == "bigbird" else 0)


def test_resolve_device_default_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


# --- cli/infer_video --title_arch bigbird|bart on the CPU ------------------


@pytest.fixture(scope="module")
def cli_case(tmp_path_factory):
    """A synthetic test corpus, a vocab file and a boundary checkpoint of
    a tiny frames-stem model with seeded random weights."""
    from video_chapter_generation_tpu_torch.cli.common import (
        load_bert_tokenizer,
        load_corpus,
        parse_config,
    )
    from video_chapter_generation_tpu_torch.core.checkpoint import (
        CheckpointManager,
    )
    from video_chapter_generation_tpu_torch.core.contract import vocab_hash
    from video_chapter_generation_tpu_torch.data.synth import (
        make_synth_corpus_on_disk,
    )
    from video_chapter_generation_tpu_torch.models.bert import BertConfig
    from video_chapter_generation_tpu_torch.train.tasks import SegmentTask

    root = tmp_path_factory.mktemp("torch_title_arch_cli")
    paths = make_synth_corpus_on_disk(str(root / "corpus"), n_videos=2,
                                      video_sec=80, hw=64, seed=3)
    overrides = [f"data.{k}={paths[k]}" for k in (
        "img_dir", "data_file", "subtitle_dir")] + [
        f"data.test_vid_file={paths['vid_file']}",
        "model.kind=two_stream", "model.stem_input=frames",
        "model.compute_dtype=float32", "data.batch_size=2",
        "data.max_text_len=16", "data.clip_frame_num=4",
        f"data.title_input_len={L_IN}", "data.title_decode_len=6"]
    cfg, args = parse_config(overrides + ["--tiny"])
    tok = load_bert_tokenizer(args, load_corpus(cfg, "test"))
    vocab = root / "vocab.txt"
    vocab.write_text("".join(tok.ids_to_tokens[i] + "\n"
                             for i in range(tok.vocab_size)))
    task = SegmentTask(cfg, tiny=True, hw=64,
                       bert_cfg=BertConfig.tiny(vocab_size=tok.vocab_size))
    contract = dict(task.contract, vocab_hash=vocab_hash(tok))
    flags = ["--tiny", "--device", "cpu", "--bert_vocab", str(vocab)]
    state = task.init_state()

    def write(ckpt_dir, sd):
        CheckpointManager(ckpt_dir).save(
            0, {"model": sd, "optimizer": {}, "step": 0},
            metrics={"best_result": 0.0, "contract": contract})
        return [f"train.ckpt_dir={ckpt_dir}"]

    # random weights score every clip near one value; shift the head bias
    # by the logit of the median score so that scores straddle 0.5 and
    # the videos get cut points (as chip_smoke.py does)
    cwd = os.getcwd()
    os.chdir(root)
    try:
        first = infer_video.main(overrides + write(f"{root}/ckpt0", state)
                                 + ["data.title_input_len=64"] + flags)
    finally:
        os.chdir(cwd)
    med = float(np.clip(np.median(np.concatenate(
        [r.clip_scores for r in first.values()])), 1e-6, 1 - 1e-6))
    bias = state["fusion_head.head.bias"].clone()
    bias[1] -= np.log(med / (1 - med))
    state["fusion_head.head.bias"] = bias
    return root, overrides + write(f"{root}/ckpt", state), flags


@pytest.mark.parametrize("arch", ARCHS)
def test_infer_video_serves_the_title_family(cli_case, arch, capsys,
                                             monkeypatch):
    root, overrides, flags = cli_case
    calls = []
    plain = sa_ops.sparse_band_attention_reference
    monkeypatch.setattr(sa_ops, "sparse_band_attention_reference",
                        lambda *a: calls.append(1) or plain(*a))
    cwd = os.getcwd()
    os.chdir(root)
    try:
        # the override after the flags, as a user types it
        results = infer_video.main(
            overrides + flags + ["--title_arch", arch,
                                 f"data.title_input_len={IN_LEN[arch]}",
                                 "--pipelined"])
    finally:
        os.chdir(cwd)
    out = capsys.readouterr().out
    assert "restored checkpoint at epoch 0" in out
    assert "random title weights" in out
    lines = [json.loads(line) for line in out.splitlines()
             if line.startswith("{")]
    assert [r["vid"] for r in lines] == list(results) and results
    for r in results.values():
        assert len(r.titles) == len(r.spans)
    # one generate per video with chapters; 2 sparse encoder layers each
    n_gen = sum(1 for r in results.values() if r.spans)
    assert n_gen >= 1
    assert len(calls) == (2 * n_gen if arch == "bigbird" else 0)


def test_title_contract_records_the_encoder_attention(tmp_path):
    """TitleGenTask's contract carries the config's encoder attention, so
    a full-attention title checkpoint does not load into BigBird."""
    from video_chapter_generation_tpu_torch.cli.eval_title import _restore
    from video_chapter_generation_tpu_torch.core.checkpoint import (
        CheckpointManager,
    )
    from video_chapter_generation_tpu_torch.core.config import Config
    from video_chapter_generation_tpu_torch.train.tasks import TitleGenTask

    cfg = Config().apply_overrides([f"train.ckpt_dir={tmp_path}",
                                    f"data.title_input_len={L_IN}"])
    task = TitleGenTask(cfg, _cfgs("bigbird")[0])
    assert task.contract["encoder_attention"] == "block_sparse"
    assert TitleGenTask(cfg, Seq2SeqConfig.tiny()).contract[
        "encoder_attention"] == "full"
    state = task.init_state()
    CheckpointManager(str(tmp_path)).save(
        0, {"model": state, "step": 1}, score=1.0,
        metrics={"contract": dict(task.contract, encoder_attention="full")})
    with pytest.raises(ContractMismatch, match="encoder_attention"):
        _restore(cfg, task)
