"""The port's vision-conditioned titles and the extraction entry point
against the JAX package on the CPU, in float32.

- VisionFusionHead and Seq2SeqVisionEmb.encode_fused for both fusion
  types, with vision masks that hold zeros (a row of zeros included), at
  1e-5; the tree layout, the HF round trip of the `seq2seq.` part, the
  int8 form of the vision tree and TitleGenVisionTask's contract.
- Greedy and beam titles through encode_fused, token for token the JAX
  infer_video title path (JAX encode_fused, then generate / beam_search on
  the inner Seq2Seq with enc_hidden_override).
- cli/extract_vision_emb of both packages on a tiny trunk (64 px, one
  block a stage, the frames stem) from the same weights: the same files,
  embeddings within 1e-4.
- cli/infer_video --vision_emb_dir --num_beams 2 of both packages on a
  synthetic corpus, from the same title weights (the port restores them
  from a title_vision checkpoint) and the same clip scores (a scorer of the
  clip index stands in for the boundary model in both, whose parity
  tests/test_torch_infer.py holds): the same cut points and titles; and
  the packed ChapterPipeline hands title_fn the JAX one's vision inputs.
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

from test_torch_beam_search import DEC_SCALE
from test_torch_models import (
    T as PIPE_T,
    _perturb,
    jax_two_stream,
    port_two_stream,
)
from test_torch_pipeline import BATCH, CPU, HW, TEXT_LEN, TITLE_IN, _decode
from test_torch_pipeline import slice_case  # noqa: F401  (a fixture)
from video_chapter_generation_tpu.cli import (
    eval_title as jax_eval_title,
    extract_vision_emb as jax_extract_cli,
    infer_video as jax_infer_cli,
)
from video_chapter_generation_tpu.cli.common import (
    title_s2s_config as jax_title_s2s_config,
)
from video_chapter_generation_tpu.core.config import Config as JaxConfig
from video_chapter_generation_tpu.data.datasets import (
    npy_vision_emb_provider as jax_npy_provider,
)
from video_chapter_generation_tpu.models.resnet import (
    Resnet50TSM as JaxResnet50TSM,
)
from video_chapter_generation_tpu.models.seq2seq import (
    Seq2Seq as JaxSeq2Seq,
    Seq2SeqVisionEmb as JaxSeq2SeqVisionEmb,
    VisionFusionHead as JaxVisionFusionHead,
    beam_search as jax_beam_search,
    convert_hf_seq2seq,
    generate as jax_generate,
)
from video_chapter_generation_tpu.ops.quantize import (
    quantize_seq2seq as jax_quantize_seq2seq,
)
from video_chapter_generation_tpu.pipeline import (
    ChapterPipeline as JaxChapterPipeline,
    make_packed_two_stream_score_fn as jax_packed_score_fn,
)
from video_chapter_generation_tpu.train.tasks import (
    TitleGenVisionTask as JaxTitleGenVisionTask,
)
from video_chapter_generation_tpu_torch.cli import (
    extract_vision_emb,
    infer_video,
)
from video_chapter_generation_tpu_torch.cli.common import title_s2s_config
from video_chapter_generation_tpu_torch.cli.eval_title import _restore
from video_chapter_generation_tpu_torch.core.checkpoint import (
    CheckpointManager,
)
from video_chapter_generation_tpu_torch.core.config import Config
from video_chapter_generation_tpu_torch.core.contract import (
    ContractMismatch,
    vocab_hash,
)
from video_chapter_generation_tpu_torch.data.datasets import (
    npy_vision_emb_provider,
)
from video_chapter_generation_tpu_torch.models import convert
from video_chapter_generation_tpu_torch.models.seq2seq import (
    FUSION_TYPES,
    Seq2SeqVisionEmb,
    beam_search,
    generate,
)
from video_chapter_generation_tpu_torch.ops.quantize import quantize_seq2seq
from video_chapter_generation_tpu_torch.pipeline import (
    ChapterPipeline,
    make_packed_two_stream_score_fn,
)
from video_chapter_generation_tpu_torch.train.tasks import (
    TitleGenTask,
    TitleGenVisionTask,
)

TOL = dict(rtol=1e-5, atol=1e-5)
VOCAB, B, L_IN, N_VIS, VIS_DIM, MAX_LEN = 96, 3, 24, 10, 48, 8
EMB_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module: its tiny models run thousands
    of small ops, which a full thread pool only slows, and by 10-70x when
    other test processes share the cores (the pool's threads contend)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(vocab=VOCAB):
    args = SimpleNamespace(tiny=True, title_arch="pegasus")
    tok = SimpleNamespace(vocab_size=vocab)
    return title_s2s_config(args, tok), jax_title_s2s_config(args, tok)


def vision_tree(net, cfg, fusion_type, seed):
    """A seeded Seq2SeqVisionEmb tree in the JAX layout with random norm
    affines and, as in tests/test_torch_beam_search.py, a decoder that
    neither echoes its input nor never ends."""
    rng = np.random.default_rng(seed)
    p = _perturb(convert.random_jax_tree(
        net, convert.vision_title_entries(cfg, fusion_type), seed=seed), rng)
    s2s = p["seq2seq"]
    for i in range(cfg.decoder_layers):
        for part in ("self_attn", "encoder_attn", "ffn"):
            for leaf in s2s[f"dec_layer{i}"][part].values():
                if "kernel" in leaf:
                    leaf["kernel"] = leaf["kernel"] * DEC_SCALE
    s2s["final_logits_bias"] = 0.5 * rng.standard_normal(
        cfg.vocab_size).astype(np.float32)
    s2s["final_logits_bias"][cfg.eos_token_id] += 2.0
    return p


@pytest.fixture(scope="module", params=FUSION_TYPES)
def case(request):
    fusion = request.param
    cfg, jcfg = _cfgs()
    net = Seq2SeqVisionEmb(cfg, fusion, VIS_DIM).eval()
    p = vision_tree(net, cfg, fusion, seed=3)
    net.load_state_dict(convert.from_jax(
        p, convert.vision_title_entries(cfg, fusion)))
    rng = np.random.default_rng(4)
    ids = rng.integers(3, VOCAB, (B, L_IN)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 17:] = 0
    vis = rng.standard_normal((B, N_VIS, VIS_DIM)).astype(np.float32)
    vmask = np.zeros((B, N_VIS), np.int32)
    vmask[0, :4] = 1
    vmask[2, :] = 1  # row 1: no embedding at all
    jm = JaxSeq2SeqVisionEmb(jcfg, fusion_type=fusion, vision_emb_size=VIS_DIM)
    return SimpleNamespace(fusion=fusion, cfg=cfg, net=net, p=p, jm=jm,
                           ids=ids, mask=mask, vis=vis, vmask=vmask)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_tree_has_the_jax_layout(case):
    ids = jnp.ones((1, 8), jnp.int32)
    want = jax.eval_shape(lambda: case.jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 3, VIS_DIM)),
        jnp.ones((1, 3), jnp.int32), ids, ids, ids[:, :4]))["params"]
    assert jax.tree_util.tree_map(np.shape, case.p) == \
        jax.tree_util.tree_map(lambda a: a.shape, want)


def test_fusion_head_matches_jax(case):
    lang = np.random.default_rng(5).standard_normal(
        (B, L_IN, case.cfg.d_model)).astype(np.float32)
    hidden = 128 if case.fusion == "mlp" else case.cfg.d_model
    head = JaxVisionFusionHead(case.cfg.d_model, VIS_DIM, hidden,
                               case.fusion)
    want = head.apply({"params": case.p["fusion_head"]}, jnp.asarray(lang),
                      jnp.asarray(case.vis), jnp.asarray(case.vmask))
    with torch.no_grad():
        got = case.net.fusion_head(*_t(lang, case.vis, case.vmask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the multiplicative key mask: a row with no embedding still attends
    assert np.abs(got.numpy()[1]).max() > 0


def test_encode_fused_matches_jax(case):
    want = case.jm.apply({"params": case.p}, jnp.asarray(case.vis),
                         jnp.asarray(case.vmask), jnp.asarray(case.ids),
                         jnp.asarray(case.mask),
                         method=case.jm.encode_fused)
    ids, mask, vis, vmask = _t(case.ids, case.mask, case.vis, case.vmask)
    got = case.net.encode_fused(vis, vmask, ids.long(), mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    plain = case.net.seq2seq.encode(ids.long(), mask)
    assert not torch.allclose(got, plain)  # the vision residual is there


@pytest.mark.parametrize("num_beams", [1, 2])
def test_titles_match_the_jax_title_path(case, num_beams):
    """cli/infer_video.py:160-196 of the JAX package: encode_fused on the
    vision model, then the inner Seq2Seq decodes from those states."""
    jm, p = case.jm, case.p
    inner = JaxSeq2Seq(jm.cfg)

    def jax_titles(p_, vis, vmask, ids, mask):
        enc = jm.apply({"params": p_}, vis, vmask, ids, mask,
                       method=jm.encode_fused)
        v = {"params": p_["seq2seq"]}
        if num_beams > 1:
            return jax_beam_search(inner, v, ids, mask, num_beams=num_beams,
                                   max_len=MAX_LEN,
                                   enc_hidden_override=enc)[0]
        return jax_generate(inner, v, ids, mask, max_len=MAX_LEN,
                            enc_hidden_override=enc,
                            return_logits=False)[0]

    want = jax.jit(jax_titles)(p, *map(jnp.asarray, (
        case.vis, case.vmask, case.ids, case.mask)))
    ids, mask, vis, vmask = _t(case.ids, case.mask, case.vis, case.vmask)
    ids = ids.long()
    enc = case.net.encode_fused(vis, vmask, ids, mask)
    if num_beams > 1:
        got = beam_search(case.net.seq2seq, ids, mask, num_beams=num_beams,
                          max_len=MAX_LEN, enc_hidden=enc)[0]
    else:
        got = generate(case.net.seq2seq, ids, mask, max_len=MAX_LEN,
                       enc_hidden=enc)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the fused states change the titles
    plain = generate(case.net.seq2seq, ids, mask, max_len=MAX_LEN)
    assert not torch.equal(plain, generate(case.net.seq2seq, ids, mask,
                                           max_len=MAX_LEN, enc_hidden=enc))


def test_seq2seq_part_round_trips_to_jax(case):
    sd = case.net.state_dict()
    inner = {k[len("seq2seq."):]: v for k, v in sd.items()
             if k.startswith("seq2seq.")}
    back = convert_hf_seq2seq(inner, case.jm.cfg)["params"]
    want = dict(jax.tree_util.tree_leaves_with_path(case.p["seq2seq"]))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k])


def test_int8_vision_tree_matches_jax(case):
    """The JAX quantize_seq2seq over the vision tree (what its infer_video
    does under --int8_titles --vision_emb_dir) and the port's over the
    state dict agree leaf for leaf; the fusion head stays float."""
    qcfg = dataclasses.replace(case.cfg, weight_quant=True, kv_quant=True)
    jq = jax_quantize_seq2seq({"params": case.p})["params"]
    carried = convert.from_jax(jq, convert.vision_title_entries(
        qcfg, case.fusion))
    got = quantize_seq2seq(case.net.state_dict())
    assert got.keys() == carried.keys()
    for k in got:
        assert got[k].dtype == carried[k].dtype and torch.equal(
            got[k], carried[k]), k
    heads = [k for k in got if k.startswith("fusion_head.")]
    assert heads and all(got[k].dtype == torch.float32 for k in heads)
    assert got["seq2seq.model.shared.embedding_q"].dtype == torch.int8
    with torch.device("meta"):
        qnet = Seq2SeqVisionEmb(qcfg, case.fusion, VIS_DIM)
    qnet.load_state_dict(got, assign=True)


def test_vision_task_contract_matches_jax():
    over = ["data.title_input_len=24", "data.title_decode_len=6"]
    cfg, jcfg = _cfgs(vocab=300)
    for fusion in FUSION_TYPES:
        port = TitleGenVisionTask(Config().apply_overrides(over), cfg,
                                  fusion, 2048)
        ref = JaxTitleGenVisionTask(JaxConfig().apply_overrides(over), jcfg,
                                    fusion_type=fusion, vision_emb_size=2048)
        assert port.contract == ref.contract
        assert port.contract["model_kind"] == "title_vision"
        assert port.init_state().keys() == port.model.state_dict().keys()


def test_vision_title_restore(tmp_path, capsys):
    """_restore loads a title_vision checkpoint into the vision task, keeps
    random weights beside a plain title checkpoint, and raises on a vision
    checkpoint of another fusion type."""
    cfg = Config().apply_overrides([f"train.ckpt_dir={tmp_path}"])
    s2s_cfg = _cfgs()[0]
    task = TitleGenVisionTask(cfg, s2s_cfg, "cross_attn", VIS_DIM)
    ckpt = CheckpointManager(str(tmp_path))
    plain = TitleGenTask(cfg, s2s_cfg)
    ckpt.save(0, {"model": plain.init_state(), "step": 0},
              metrics={"contract": plain.contract})
    init = _restore(cfg, task)
    assert "is a title checkpoint" in capsys.readouterr().out
    assert init.keys() == task.model.state_dict().keys()
    trained = {k: v + 1 for k, v in init.items()}
    ckpt.save(1, {"model": trained, "step": 4}, score=1.0,
              metrics={"contract": task.contract})
    got = _restore(cfg, task)
    assert all(torch.equal(got[k], trained[k]) for k in trained)
    ckpt.save(2, {"model": trained, "step": 8}, score=2.0, metrics={
        "contract": dict(task.contract, fusion_type="mlp")})
    with pytest.raises(ContractMismatch, match="fusion_type"):
        _restore(cfg, task)


# --- the two entry points on a synthetic corpus ---------------------------


@pytest.fixture(scope="module")
def corpus_case(tmp_path_factory):
    """Two 60-s synthetic videos at 64 px, a vocab file and the clips JSON
    of their 16-frame clips (the extraction CLI's input)."""
    from video_chapter_generation_tpu_torch.cli.common import (
        load_bert_tokenizer,
        load_corpus,
        parse_config,
    )
    from video_chapter_generation_tpu_torch.data.clip_grid import (
        flatten_video_to_clips,
    )
    from video_chapter_generation_tpu_torch.data.synth import (
        make_synth_corpus_on_disk,
    )

    root = tmp_path_factory.mktemp("torch_vision_titles")
    paths = make_synth_corpus_on_disk(str(root / "corpus"), n_videos=2,
                                      video_sec=60, hw=64, seed=5)
    data = [f"data.{k}={paths[k]}" for k in (
        "img_dir", "data_file", "subtitle_dir")] + [
        f"data.test_vid_file={paths['vid_file']}", "data.batch_size=4"]
    cfg, args = parse_config(data + ["--tiny"])
    corpus = load_corpus(cfg, "test")
    tok = load_bert_tokenizer(args, corpus)
    vocab = root / "vocab.txt"
    vocab.write_text("".join(tok.ids_to_tokens[i] + "\n"
                             for i in range(tok.vocab_size)))
    clips = [c.to_json() for vid in corpus.vids
             for c in flatten_video_to_clips(
                 vid, corpus.img_dir, corpus.image_num(vid),
                 corpus.raw_cut_secs(vid), corpus.subtitles(vid), 16)]
    clips_json = root / "clips.json"
    clips_json.write_text(json.dumps(clips))
    return root, data, str(vocab), str(clips_json), len(clips)


def _jax_trunk_variables():
    """The JAX CLI's trunk weights: its tiny Resnet50TSM initialized from
    PRNGKey(0) (cli/extract_vision_emb.py:50-56)."""
    model = JaxResnet50TSM(segments_size=16, dtype=jnp.float32,
                           stem_input="frames", stage_sizes=(1, 1, 1, 1))
    x0 = jnp.zeros((1, 16, 64, 64, 3), jnp.float32)
    return jax.jit(lambda: model.init(jax.random.PRNGKey(0), x0,
                                      train=False))()


def _npys(out_dir):
    return {os.path.relpath(os.path.join(d, f), out_dir): np.load(
        os.path.join(d, f)) for d, _, files in os.walk(out_dir)
        for f in files}


@pytest.fixture(scope="module")
def emb_dirs(corpus_case, tmp_path_factory):
    root, data, _, clips_json, n_clips = corpus_case
    v = _jax_trunk_variables()
    sub = {"params": v["params"]["base_model"],
           "batch_stats": v["batch_stats"]["base_model"]}
    weights = convert.from_jax_resnet(jax.tree_util.tree_map(np.asarray,
                                                              sub),
                                      (1, 1, 1, 1))
    argv = data + [f"data.test_clips_json={clips_json}",
                   "data.clip_frame_num=16", "--tiny"]
    jax_dir, port_dir = str(root / "embs_jax"), str(root / "embs_port")
    jax_extract_cli.main(argv + ["--out_dir", jax_dir])
    mp = pytest.MonkeyPatch()
    mp.setattr(extract_vision_emb, "init_weights", lambda model: weights)
    try:
        count = extract_vision_emb.main(argv + ["--out_dir", port_dir,
                                                "--device", "cpu"])
    finally:
        mp.undo()
    assert count == n_clips
    return jax_dir, port_dir


def test_extract_vision_emb_writes_the_jax_files(emb_dirs, corpus_case):
    jax_dir, port_dir = emb_dirs
    want, got = _npys(jax_dir), _npys(port_dir)
    assert sorted(got) == sorted(want) and len(got) == corpus_case[4]
    assert all(name.split(os.sep)[-1].startswith("vision_emb_")
               for name in got)
    for name in want:
        assert got[name].shape == (16, 2048) and got[name].dtype == np.float32
        np.testing.assert_allclose(got[name], want[name], **EMB_TOL)


def test_extract_vision_emb_int8_runs_on_the_cpu(corpus_case, tmp_path,
                                                 capsys):
    """--int8 calibrates on the first batch and serves the W8A8 twin (the
    tiny trunk's one block a stage leaves no block quantized: the
    embeddings equal the float ones; tests/test_torch_int8.py holds the
    W8A8 trunk itself)."""
    _, data, _, clips_json, n_clips = corpus_case
    argv = data + [f"data.test_clips_json={clips_json}",
                   "data.clip_frame_num=16", "--tiny", "--device", "cpu"]
    a, b = str(tmp_path / "f"), str(tmp_path / "q")
    assert extract_vision_emb.main(argv + ["--out_dir", a]) == n_clips
    assert extract_vision_emb.main(argv + ["--out_dir", b, "--int8"]) == \
        n_clips
    fa, fb = _npys(a), _npys(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k])
    assert f"wrote {n_clips} clip embeddings" in capsys.readouterr().out


def _fake_score_fn(batch):
    """A stand-in boundary scorer: positive on every fifth clip index."""
    idx = np.asarray(batch["clip_index"])
    return np.where(idx % 5 == 2, 0.9, 0.1).astype(np.float32)


def _title_setup(corpus_case):
    """The tiny title config of both CLIs (vocabulary of the corpus's
    unigram tokenizer) and one title_vision tree in the JAX layout."""
    from video_chapter_generation_tpu_torch.cli.common import (
        load_corpus,
        load_title_tokenizer,
        parse_config,
    )

    _, data, _, _, _ = corpus_case
    cfg, args = parse_config(data + ["--tiny"])
    title_tok = load_title_tokenizer(args, load_corpus(cfg, "test"))
    s2s_cfg, jcfg = _cfgs(vocab=title_tok.vocab_size)
    with torch.device("meta"):
        net = Seq2SeqVisionEmb(s2s_cfg, "cross_attn", 2048)
    return title_tok, s2s_cfg, jcfg, vision_tree(net, s2s_cfg, "cross_attn",
                                                 seed=9)


@pytest.mark.parametrize("pipelined", [True, False],
                         ids=["pipelined", "sequential"])
def test_infer_video_vision_titles_match_the_jax_cli(
        corpus_case, emb_dirs, monkeypatch, tmp_path, capsys, pipelined):
    root, data, vocab, _, _ = corpus_case
    _, port_dir = emb_dirs
    title_tok, s2s_cfg, _, p = _title_setup(corpus_case)
    over = data + ["model.kind=two_stream", "model.compute_dtype=float32",
                   "data.clip_frame_num=4", "data.max_text_len=16",
                   "data.title_input_len=24", "data.title_decode_len=6",
                   f"train.ckpt_dir={tmp_path}/ckpt"]
    flags = ["--tiny", "--bert_vocab", vocab, "--vision_emb_dir", port_dir,
             "--num_beams", "2"] + (["--pipelined"] if pipelined else [])

    # the port restores the title weights from a title_vision checkpoint
    cfg = Config().apply_overrides(over)
    task = TitleGenVisionTask(cfg, s2s_cfg, "cross_attn", 2048)
    CheckpointManager(f"{tmp_path}/ckpt").save(
        0, {"model": convert.from_jax(p, task.entries), "step": 3},
        metrics={"contract": dict(task.contract,
                                  vocab_hash=vocab_hash(title_tok))})
    monkeypatch.setattr(infer_video, "build_score_fn",
                        lambda *a, **k: _fake_score_fn)
    monkeypatch.setattr(jax_infer_cli, "build_score_fn",
                        lambda *a, **k: _fake_score_fn)
    monkeypatch.setattr(jax_eval_title, "_restore",
                        lambda cfg, task: {"params": p})
    monkeypatch.chdir(tmp_path)
    got = infer_video.main(over + flags + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "restored checkpoint at epoch 0 (step 3)" in out
    jax_infer_cli.main(over + flags)
    want = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    assert [w["vid"] for w in want] == list(got)
    n_titles = 0
    for w in want:
        r = got[w["vid"]]
        assert r.cut_points == w["cut_points"] and r.cut_points
        assert r.titles == w["titles"] and len(r.titles) == len(r.spans)
        n_titles += sum(1 for t in r.titles if t)
    assert n_titles  # titles are text, not all empty


def test_infer_video_int8_vision_titles_run(corpus_case, emb_dirs,
                                            monkeypatch, tmp_path):
    """--int8_titles with --vision_emb_dir and the mlp head: the int8
    Seq2Seq core under the float fusion head serves every chapter."""
    _, data, vocab, _, _ = corpus_case
    monkeypatch.setattr(infer_video, "build_score_fn",
                        lambda *a, **k: _fake_score_fn)
    monkeypatch.chdir(tmp_path)
    results = infer_video.main(data + [
        "model.kind=two_stream", "data.clip_frame_num=4",
        "data.max_text_len=16", "data.title_input_len=24",
        "data.title_decode_len=6", f"train.ckpt_dir={tmp_path}/ckpt",
        "--tiny", "--device", "cpu", "--bert_vocab", vocab,
        "--vision_emb_dir", emb_dirs[1], "--fusion_type", "mlp",
        "--num_beams", "3", "--int8_titles"])
    assert results and all(r.cut_points and len(r.titles) == len(r.spans)
                           for r in results.values())


def test_unknown_fusion_type_exits(corpus_case):
    _, data, vocab, _, _ = corpus_case
    with pytest.raises(SystemExit, match="cross_attn, mlp"):
        infer_video.main(data + ["--tiny", "--device", "cpu",
                                 "--vision_emb_dir", "embs",
                                 "--fusion_type", "concat"])


def test_entry_points_default_to_the_card(corpus_case, monkeypatch):
    """Without --device and without CUDA both CLIs raise before any work:
    they never run on the CPU unasked."""
    _, data, vocab, clips_json, _ = corpus_case
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        extract_vision_emb.main(data + [f"data.test_clips_json={clips_json}",
                                        "--tiny"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        infer_video.main(data + ["model.kind=two_stream", "--tiny",
                                 "--bert_vocab", vocab, "--vision_emb_dir",
                                 "embs", "--num_beams", "4"])


@pytest.mark.parametrize("pipelined", [False, True])
def test_packed_pipeline_passes_the_vision_inputs(slice_case,  # noqa: F811
                                                  tmp_path, pipelined):
    """The packed ChapterPipeline route hands title_fn the same chapter
    vision inputs as the JAX one (npy provider, mean over T, padding to
    max_vision_emb, int32 mask), beside the same cut points."""
    from fixtures import make_unigram, make_wordpiece

    corpus, variables, _, _ = slice_case
    vid = corpus.vids[0]
    rng = np.random.default_rng(6)
    (tmp_path / vid).mkdir()
    for st in range(0, 24, 4):
        np.save(tmp_path / vid / f"vision_emb_{st}_{st + 16}.npy",
                rng.standard_normal((16, 2048)).astype(np.float32))
    seen = {"port": [], "jax": []}

    def title_fn(who):
        def fn(ids, mask, vis, vmask):
            seen[who].append((ids, mask, vis, vmask))
            return ids[:, :3]
        return fn

    kw = dict(clip_frame_num=PIPE_T, max_text_len=TEXT_LEN,
              title_input_len=TITLE_IN, batch_size=BATCH, score_mode="all",
              hw=HW, frame_pack=True, max_vision_emb=4)
    port = ChapterPipeline(
        corpus, make_wordpiece(),
        make_packed_two_stream_score_fn(port_two_stream(variables), CPU),
        title_fn("port"), _decode, title_tokenizer=make_unigram(),
        device=CPU, vision_emb_provider=npy_vision_emb_provider(
            str(tmp_path)), **kw)
    ref = JaxChapterPipeline(
        corpus, make_wordpiece(),
        jax_packed_score_fn(jax_two_stream(), variables), title_fn("jax"),
        _decode, title_tokenizer=make_unigram(),
        vision_emb_provider=jax_npy_provider(str(tmp_path)), **kw)
    got = port.run(pipelined=pipelined)[vid]
    want = ref.run(pipelined=pipelined)[vid]
    assert got.cut_points and got.cut_points == want.cut_points
    assert got.titles == want.titles
    assert len(seen["port"]) == len(seen["jax"]) == 1
    for a, b in zip(seen["port"][0], seen["jax"][0]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    vmask = seen["port"][0][3]
    assert vmask.shape == (len(got.spans), 4) and vmask.sum() > 0
