"""The port's evaluation entry points against the JAX package's, on the
CPU, in float32, on a synthetic corpus (2 test videos of 40 s, 64-px
frames) flattened into a clips JSON by both packages' datasetkit/flatten.

- cli/eval_segment.main of both packages for model.kind text, two_stream
  (frames stem) and two_stream_window, tiny, from the same weights: the
  port restores them from a checkpoint it wrote, the JAX CLI takes them
  as its task's initial variables (monkeypatched init_variables, no
  checkpoint in its directory). Clip scores within 1e-5; the labels at
  0.5 are compared, and where one flips the end-to-end comparison falls
  back to the metric step on the JAX scores (none flipped when this was
  written); evaluate_segment_predictions of both packages on the same
  scored clips gives equal dicts; both writers give equal files from the
  same result; the text kind again with --compat_first_clip. The tiny
  JAX two-stream models take BERT tiny at its fixed vocabulary of 128
  (train/tasks.py:33) where the port takes the tokenizer's: the
  tokenizer here has exactly 128 entries, so the two models have the
  same shapes.
- cli/eval_title.main of both packages (Pegasus, BART and BigBird tiny;
  --location gt and pred; --num_beams 2; --int8_titles; --vision_emb_dir)
  from the same title weights (the port restores a checkpoint, the JAX
  CLI's _restore is monkeypatched to the carried tree, as
  tests/test_torch_vision_titles.py does): the same generated texts and
  ROUGE, loss and accuracy within 1e-5, and result files that agree
  line for line (loss and accuracy lines within 1e-5).
- The port's _restore raises on a truncated checkpoint of its kind (the
  JAX one falls back to random weights on any exception), and
  eval_title refuses flags it cannot serve.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import video_chapter_generation_tpu.train.tasks as jax_tasks
from test_torch_models import _perturb
from video_chapter_generation_tpu.cli import (
    eval_segment as jax_eval_segment,
    eval_title as jax_eval_title,
)
from video_chapter_generation_tpu.datasetkit import flatten as jax_flatten
from video_chapter_generation_tpu.evalkit import (
    segment_eval as jax_segment_eval,
    title_eval as jax_title_eval,
)
from video_chapter_generation_tpu_torch.cli import eval_segment, eval_title
from video_chapter_generation_tpu_torch.cli.common import (
    load_corpus,
    load_title_tokenizer,
    parse_config,
    title_s2s_config,
)
from video_chapter_generation_tpu_torch.core.checkpoint import (
    CheckpointManager,
)
from video_chapter_generation_tpu_torch.core.contract import vocab_hash
from video_chapter_generation_tpu_torch.data.synth import (
    make_synth_corpus_on_disk,
)
from video_chapter_generation_tpu_torch.data.tokenization import (
    WordPieceTokenizer,
)
from video_chapter_generation_tpu_torch.datasetkit import flatten
from video_chapter_generation_tpu_torch.evalkit import segment_eval
from video_chapter_generation_tpu_torch.models import convert
from video_chapter_generation_tpu_torch.models.bert import BertConfig
from video_chapter_generation_tpu_torch.train.tasks import (
    SegmentTask,
    SegmentTextTask,
    SegmentWindowTask,
    TitleGenTask,
    TitleGenVisionTask,
)

CLIP_FRAMES, BERT_VOCAB = 4, 128
SCORE_TOL, TITLE_TOL = 1e-5, 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def eval_corpus(tmp_path_factory):
    """The corpus, its clips JSON (the port's flatten; the JAX one writes
    the same file), a 128-entry WordPiece vocab file and the data
    overrides."""
    root = tmp_path_factory.mktemp("eval_corpus")
    # learnable: the titles' words stand in the chapters' subtitles, so
    # the ROUGE of the baselines is not all zeros
    paths = make_synth_corpus_on_disk(str(root), n_videos=2, video_sec=40,
                                      hw=64, seed=3, splits={"test": 2},
                                      learnable=True)
    flat = ["--img_dir", paths["img_dir"], "--data_file", paths["data_file"],
            "--vid_file", paths["test_vid_file"], "--subtitle_dir",
            paths["subtitle_dir"], "--clip_frame_num", str(CLIP_FRAMES)]
    clips = str(root / "clips.json")
    flatten.main(flat + ["--out", clips])
    jax_flatten.main(flat + ["--out", str(root / "clips_jax.json")])
    assert Path(clips).read_text() == (root / "clips_jax.json").read_text()
    texts = [c["text_clip"] for c in json.load(open(clips))]
    tok = WordPieceTokenizer.build_from_corpus(texts, vocab_size=BERT_VOCAB)
    words = sorted(tok.vocab, key=tok.vocab.get)
    words += [f"[unused{i}]" for i in range(BERT_VOCAB - len(words))]
    vocab = root / "vocab.txt"
    vocab.write_text("\n".join(words) + "\n")
    assert WordPieceTokenizer.from_vocab_file(str(vocab)).vocab_size == \
        BERT_VOCAB
    data = [f"data.img_dir={paths['img_dir']}",
            f"data.data_file={paths['data_file']}",
            f"data.subtitle_dir={paths['subtitle_dir']}",
            f"data.test_vid_file={paths['test_vid_file']}",
            f"data.test_clips_json={clips}"]
    return root, data, str(vocab)


# --------------------------------------------------------------------------
# cli/eval_segment
# --------------------------------------------------------------------------

JAX_TASK = {"text": jax_tasks.SegmentTextTask,
            "two_stream": jax_tasks.SegmentTask,
            "two_stream_window": jax_tasks.SegmentWindowTask}


def _port_task(cfg, kind):
    """The task build_score_fn builds for this kind (tiny, 64 px)."""
    if kind == "text":
        return SegmentTextTask(cfg, tiny=True, vocab_size=BERT_VOCAB)
    cls = SegmentTask if kind == "two_stream" else SegmentWindowTask
    return cls(cfg, tiny=True, hw=64, bert_cfg=BertConfig.tiny(BERT_VOCAB))


def _capture(monkeypatch, module, into):
    """Wrap a CLI module's evaluate_segment_predictions: keep the scored
    clips it is given and the result it returns."""
    real = module.evaluate_segment_predictions

    def spy(clips, *args, **kw):
        into["clips"] = [dict(vars(c)) for c in clips]
        into["result"] = real(clips, *args, **kw)
        return into["result"]

    monkeypatch.setattr(module, "evaluate_segment_predictions", spy)


@pytest.mark.parametrize("kind,flags", [
    ("text", []), ("text", ["--compat_first_clip"]), ("two_stream", []),
    ("two_stream_window", [])], ids=["text", "text-compat", "two_stream",
                                     "two_stream_window"])
def test_eval_segment_matches_the_jax_cli(eval_corpus, tmp_path,
                                          monkeypatch, capsys, kind, flags):
    root, data, vocab = eval_corpus
    over = data + [f"model.kind={kind}", "model.compute_dtype=float32",
                   f"data.clip_frame_num={CLIP_FRAMES}",
                   "data.max_text_len=16", "data.batch_size=4",
                   "model.hidden_size=16"]
    cfg, _ = parse_config(over + ["--tiny"])
    task = _port_task(cfg, kind)
    tree = convert.random_jax_tree(task.model, task.entries, seed=7)
    _perturb(tree, np.random.default_rng(7))
    tok = WordPieceTokenizer.from_vocab_file(vocab)

    def save():
        CheckpointManager(str(tmp_path / "ckpt")).save(
            0, {"model": convert._with_bn_counters(
                convert.from_jax(tree, task.entries)), "step": 5},
            metrics={"contract": dict(task.contract,
                                      vocab_hash=vocab_hash(tok))})

    # the classifier's bias shifted so that the clip scores straddle 0.5
    # (a port run on the random weights gives their median), so that
    # both labels and real cut points reach the metric step
    save()
    seen = {"port": {}, "jax": {}}
    _capture(monkeypatch, eval_segment, seen["port"])
    (tmp_path / "centre").mkdir()
    monkeypatch.chdir(tmp_path / "centre")
    eval_segment.main(over + [f"train.ckpt_dir={tmp_path / 'ckpt'}",
                              "--tiny", "--bert_vocab", vocab, "--device",
                              "cpu"])
    med = float(np.median([c["pred_score"] for c in seen["port"]["clips"]]))
    head = [path for path, key, _ in task.entries
            if key in ("head.bias", "fusion_head.head.bias",
                       "window_attn.classifier.bias")][0]
    convert._get(tree, head)[1] -= np.float32(np.log(med / (1 - med)))
    save()
    monkeypatch.setattr(JAX_TASK[kind], "init_variables",
                        lambda self: jax.tree_util.tree_map(jnp.asarray,
                                                            tree))
    _capture(monkeypatch, jax_eval_segment, seen["jax"])
    files = {}
    for who, main, ckpt, extra in (
            ("port", eval_segment.main, tmp_path / "ckpt", ["--device",
                                                            "cpu"]),
            ("jax", jax_eval_segment.main, tmp_path / "jax_ckpt", [])):
        (tmp_path / who).mkdir()
        monkeypatch.chdir(tmp_path / who)
        main(over + flags + [f"train.ckpt_dir={ckpt}", "--tiny",
                             "--bert_vocab", vocab] + extra)
        prefix = tmp_path / who / "test_results" / f"{kind}_head_mlp"
        files[who] = (Path(f"{prefix}.txt").read_text(),
                      Path(f"{prefix}_vid2cut_points.json").read_text())
    assert "restored checkpoint at epoch 0 (step 5)" in \
        capsys.readouterr().out

    port, want = seen["port"]["clips"], seen["jax"]["clips"]
    assert len(port) == len(want) > 0
    assert [c["vid"] for c in port] == [c["vid"] for c in want]
    ps = np.asarray([c["pred_score"] for c in port])
    js = np.asarray([c["pred_score"] for c in want])
    np.testing.assert_allclose(ps, js, rtol=0, atol=SCORE_TOL)
    # the metric step of both packages on the same (JAX) scored clips
    rng = np.random.default_rng(cfg.train.seed)
    infos = [segment_eval.ClipInfo(**c) for c in want]
    compat = bool(flags)
    got = segment_eval.evaluate_segment_predictions(
        infos, CLIP_FRAMES, 2, rng=np.random.default_rng(cfg.train.seed),
        compat_first_clip_double_count=compat)
    ref = jax_segment_eval.evaluate_segment_predictions(
        [jax_segment_eval.ClipInfo(**c) for c in want], CLIP_FRAMES, 2,
        rng=rng, compat_first_clip_double_count=compat)
    assert got == ref
    assert got == seen["jax"]["result"]
    labels = [c["pred_label"] for c in want]
    assert 0 < sum(labels) < len(labels)
    for writer, who in ((segment_eval.write_segment_result_files, "p"),
                        (jax_segment_eval.write_segment_result_files, "j")):
        writer(got, str(tmp_path / f"{who}.txt"),
               str(tmp_path / f"{who}.json"))
    assert (tmp_path / "p.txt").read_text() == (tmp_path / "j.txt").read_text()
    assert (tmp_path / "p.json").read_text() == \
        (tmp_path / "j.json").read_text()
    # end to end: where no label flips at 0.5, the port CLI's cut points,
    # recall, precision and F and its vid2cut_points file are the JAX
    # CLI's (mAP and AUC rank scores that differ in the last bits, held
    # above through the metric step on the same scores)
    if [c["pred_label"] for c in port] == [c["pred_label"] for c in want]:
        res = seen["port"]["result"]
        for k, v in seen["jax"]["result"].items():
            if k not in ("mAP", "AUC"):
                assert res[k] == v, k
        assert files["port"][1] == files["jax"][1]
        assert files["port"][0].splitlines()[1:] == \
            files["jax"][0].splitlines()[1:]


def test_eval_segment_refuses_int8_text(eval_corpus):
    _, data, vocab = eval_corpus
    with pytest.raises(SystemExit, match="two-stream"):
        eval_segment.main(data + ["model.kind=text", "--int8_vision",
                                  "--tiny", "--device", "cpu"])


# --------------------------------------------------------------------------
# cli/eval_title
# --------------------------------------------------------------------------

def _title_tree(task, cfg, seed):
    """Seeded title weights in the JAX layout whose decoder writes titles
    of several tokens: its projections scaled by 5 and its logits biased
    by 0.5 N(0, 1), with EOS 3 below (random tiny decoders otherwise emit
    EOS first or echo one token)."""
    rng = np.random.default_rng(seed)
    p = convert.random_jax_tree(task.model, task.entries, seed=seed)
    s2s = p.get("seq2seq", p)
    for i in range(cfg.decoder_layers):
        for part in s2s[f"dec_layer{i}"].values():
            for leaf in part.values() if isinstance(part, dict) else ():
                if isinstance(leaf, dict) and "kernel" in leaf:
                    leaf["kernel"] = leaf["kernel"] * 5.0
    bias = 0.5 * rng.standard_normal(cfg.vocab_size).astype(np.float32)
    bias[cfg.eos_token_id] -= 3.0
    s2s["final_logits_bias"] = bias
    return p


@pytest.fixture(scope="module")
def cut_points(eval_corpus):
    """A vid2cut_points.json as cli/eval_segment writes it: predicted
    cut points that differ from the ground truth."""
    root, data, _ = eval_corpus
    cfg, _ = parse_config(data)
    corpus = load_corpus(cfg, "test")
    raw = {vid: {"second_gt_cut_points": corpus.raw_cut_secs(vid),
                 "second_pred_cut_points": [7, 22, 31][:2 + k % 2]}
           for k, vid in enumerate(corpus.vids)}
    path = root / "vid2cut_points.json"
    path.write_text(json.dumps(raw))
    return str(path)


@pytest.fixture(scope="module")
def emb_dir(eval_corpus):
    """Random 16-s block embeddings for every clip of the test videos."""
    root, data, _ = eval_corpus
    cfg, _ = parse_config(data)
    corpus = load_corpus(cfg, "test")
    rng = np.random.default_rng(11)
    out = root / "vision_embs"
    for vid in corpus.vids:
        (out / vid).mkdir(parents=True)
        for st in range(0, corpus.image_num(vid), 4):
            np.save(out / vid / f"vision_emb_{st}_{st + 16}.npy",
                    rng.standard_normal((16, 2048)).astype(np.float32))
    return str(out)


TITLE_CASES = {
    "pegasus-pred-beam2": ("pegasus", ["--location", "pred",
                                       "--num_beams", "2"]),
    "pegasus-gt-int8": ("pegasus", ["--int8_titles"]),
    "bart-gt": ("bart", []),
    "bigbird-pred": ("bigbird", ["--location", "pred"]),
    "vision-pred": ("pegasus", ["--location", "pred", "--vision_emb_dir"]),
}


@pytest.mark.parametrize("case", list(TITLE_CASES))
def test_eval_title_matches_the_jax_cli(eval_corpus, cut_points, emb_dir,
                                        tmp_path, monkeypatch, capsys, case):
    _, data, _ = eval_corpus
    arch, flags = TITLE_CASES[case]
    flags = list(flags)
    if "--vision_emb_dir" in flags:
        flags.append(emb_dir)
    if "pred" in flags:
        flags += ["--cut_points", cut_points]
    in_len = 128 if arch == "bigbird" else 24  # BigBird tiny is sparse
    over = data + ["model.compute_dtype=float32", "data.batch_size=8",
                   f"data.title_input_len={in_len}",
                   "data.title_decode_len=6",
                   f"train.ckpt_dir={tmp_path / 'ckpt'}"]
    flags += ["--title_arch", arch, "--tiny"]
    cfg, args = parse_config(over + ["--title_arch", arch, "--tiny"])
    tok = load_title_tokenizer(args, load_corpus(cfg, "test"))
    s2s = title_s2s_config(args, tok)
    vision = "--vision_emb_dir" in flags
    task = (TitleGenVisionTask(cfg, s2s, "cross_attn", 2048) if vision
            else TitleGenTask(cfg, s2s))
    p = _title_tree(task, s2s, seed=13)
    CheckpointManager(str(tmp_path / "ckpt")).save(
        0, {"model": convert.from_jax(p, task.entries), "step": 2},
        metrics={"contract": dict(task.contract, vocab_hash=vocab_hash(tok))})
    monkeypatch.setattr(jax_eval_title, "_restore",
                        lambda cfg, task: {"params": p})
    seen = {}
    real = jax_title_eval.evaluate_titles  # the JAX CLI imports it in main

    def spy(gen, gt, src, **kw):
        seen.update(gen=list(gen), gt=list(gt), src=list(src))
        seen["result"] = real(gen, gt, src, **kw)
        return seen["result"]

    monkeypatch.setattr(jax_title_eval, "evaluate_titles", spy)
    for who in ("port", "jax"):
        (tmp_path / who).mkdir()
        monkeypatch.chdir(tmp_path / who)
        if who == "port":
            got = eval_title.main(over + flags + ["--device", "cpu"])
        else:
            jax_eval_title.main(over + flags)
    assert "restored checkpoint at epoch 0 (step 2)" in \
        capsys.readouterr().out
    want = seen["result"]
    assert got["gen_texts"] == seen["gen"]
    assert any(seen["gen"]) and len(seen["gen"]) == len(seen["gt"])
    assert want["generated"]["rouge-1"]["f"] > 0 or \
        want["principal"]["rouge-1"]["f"] > 0
    for k in ("generated", "random", "lead", "principal"):
        assert got[k] == want[k], k
    for k in ("test_loss", "test_acc"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TITLE_TOL)
    name = (f"test_results/chapter_title_gen/{'vision_' if vision else ''}"
            f"{'pred' if 'pred' in flags else 'gt'}_batch_8.txt")
    lines = {who: (tmp_path / who / name).read_text().splitlines()
             for who in ("port", "jax")}
    assert len(lines["port"]) == len(lines["jax"]) == 15
    assert sum(line.startswith(("random", "lead", "principal", "rouge-"))
               for line in lines["port"]) == 12
    for a, b in zip(lines["port"], lines["jax"]):
        if a.startswith("test_"):
            np.testing.assert_allclose(float(a.split()[1]),
                                       float(b.split()[1]), rtol=0,
                                       atol=TITLE_TOL)
        else:
            assert a == b


def test_title_restore_raises_on_a_truncated_checkpoint(eval_corpus,
                                                        tmp_path, capsys):
    _, data, _ = eval_corpus
    cfg, args = parse_config(data + ["model.compute_dtype=float32",
                                     f"train.ckpt_dir={tmp_path}",
                                     "--tiny"])
    tok = load_title_tokenizer(args, load_corpus(cfg, "test"))
    task = TitleGenTask(cfg, title_s2s_config(args, tok))
    task.contract = dict(task.contract, vocab_hash=vocab_hash(tok))
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(0, {"model": task.init_state(), "step": 1},
              metrics={"contract": task.contract})
    pt = next(tmp_path.glob("ckpt_0.pt"))
    size = os.path.getsize(pt)
    with open(pt, "r+b") as f:
        f.truncate(size // 2)
    with pytest.raises(Exception) as err:
        eval_title._restore(cfg, task)
    assert not isinstance(err.value, SystemExit)
    assert "random title weights" not in capsys.readouterr().out


@pytest.mark.parametrize("flags,match", [
    (["--location", "pred"], "--cut_points"),
    (["--location", "both"], "gt or pred"),
    (["--int8_titles", "--vision_emb_dir", "embs"], "text-only"),
    (["--fusion_type", "concat"], "cross_attn, mlp")])
def test_eval_title_refuses(eval_corpus, flags, match):
    _, data, _ = eval_corpus
    with pytest.raises(SystemExit, match=match):
        eval_title.main(data + flags + ["--tiny", "--device", "cpu"])
