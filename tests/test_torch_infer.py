"""The port's inference CLI slice against the JAX package, on the CPU.

- K8's plain versions: stem_frames (float32) against the JAX
  stem_conv_bn_pool_pallas in interpret mode at 1e-5, and bn_relu_maxpool
  against bn_relu_maxpool_pallas and bn_relu_maxpool_reference at 1e-5.
- A tiny TwoStream with the frames stem (BERT tiny, ResNet-TSM with stage
  sizes (1, 2, 2, 2), T = 4, 32-px frames, float32): make_two_stream_score_fn
  and the unpacked ChapterPipeline against the JAX package's, without and
  with W8A8 scales (the JAX calibration, fed to both): scores at 1e-5
  without them and at 1e-3 with them (a float32 difference in the last
  bit can move one activation across a requantization boundary, see
  tests/test_torch_int8.py), equal cut points and titles.
- CheckpointManager against the JAX package's orbax manager: the same
  score sequences (None among them) keep the same epochs, and the best is
  the same.
- score_clips' prefetch thread: a failing batch raises its error.
- cli/infer_video on a synthetic corpus after the port's train_segment
  wrote a frames-stem checkpoint: it restores it, a contract mismatch
  raises, --int8_vision --int8_titles --pipelined runs, --sharded
  (two CPU shards) gives the unsharded run's cut points and titles,
  and the window model exits naming the JAX package's fault; the title
  restore loads a title checkpoint, raises on one whose contract does not
  match and keeps random weights beside a checkpoint of another kind.
"""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import video_chapter_generation_tpu.models.resnet as jax_resnet
from fixtures import make_unigram, make_wordpiece
from test_torch_models import _perturb
from video_chapter_generation_tpu.core.checkpoint import (
    CheckpointManager as JaxCheckpointManager,
)
from video_chapter_generation_tpu.data.corpus import VideoCorpus
from video_chapter_generation_tpu.data.synth import make_synth_corpus_on_disk
from video_chapter_generation_tpu.models.bert import (
    BertConfig as JaxBertConfig,
    BertModel as JaxBertModel,
)
from video_chapter_generation_tpu.models.fusion import (
    TwoStream as JaxTwoStream,
)
from video_chapter_generation_tpu.models.seq2seq import (
    Seq2Seq as JaxSeq2Seq,
    Seq2SeqConfig as JaxSeq2SeqConfig,
    generate as jax_generate,
)
from video_chapter_generation_tpu.ops.quantize import (
    calibrate_two_stream_quant as jax_calibrate_two_stream,
)
from video_chapter_generation_tpu.ops.stem_pallas import (
    bn_relu_maxpool_pallas,
    bn_relu_maxpool_reference as jax_bn_relu_maxpool_reference,
    stem_conv_bn_pool_pallas,
)
from video_chapter_generation_tpu.pipeline import (
    ChapterPipeline as JaxChapterPipeline,
)
from video_chapter_generation_tpu.pipeline.boundary import (
    make_two_stream_score_fn as jax_score_fn,
)
from video_chapter_generation_tpu_torch.cli import infer_video, train_segment
from video_chapter_generation_tpu_torch.core.checkpoint import (
    CheckpointManager,
)
from video_chapter_generation_tpu_torch.core.contract import ContractMismatch
from video_chapter_generation_tpu_torch.models import convert
from video_chapter_generation_tpu_torch.models.bert import (
    BertConfig,
    BertModel,
)
from video_chapter_generation_tpu_torch.models.fusion import TwoStream
from video_chapter_generation_tpu_torch.models.resnet import ResNet
from video_chapter_generation_tpu_torch.models.seq2seq import (
    Seq2Seq,
    Seq2SeqConfig,
    generate,
)
from video_chapter_generation_tpu_torch.ops.stem import (
    bn_relu_maxpool,
    bn_relu_maxpool_reference,
    stem_frames,
)
from video_chapter_generation_tpu_torch.pipeline import (
    ChapterPipeline,
    make_two_stream_score_fn,
    score_clips,
)

CPU = torch.device("cpu")
SIZES, T, HW, B, HIDDEN = (1, 2, 2, 2), 4, 32, 4, 16
TEXT_LEN, TITLE_IN, TITLE_OUT = 16, 24, 6
TOL = dict(rtol=1e-5, atol=1e-5)


def test_stem_frames_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    w7 = (rng.standard_normal((7, 7, 3, 64)) * 0.1).astype(np.float32)
    s = (rng.standard_normal(64) * 0.2 + 1).astype(np.float32)
    b = (rng.standard_normal(64) * 0.2).astype(np.float32)
    want = stem_conv_bn_pool_pallas(*map(jnp.asarray, (x, w7, s, b)))
    got = stem_frames(*map(torch.from_numpy, (x, w7, s, b)))
    assert got.shape == (4, 8, 8, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("c", [64, 256])
def test_bn_relu_maxpool_matches_jax(c):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 16, 12, c)).astype(np.float32)
    s = rng.standard_normal(c).astype(np.float32)
    b = rng.standard_normal(c).astype(np.float32)
    got = bn_relu_maxpool(*map(torch.from_numpy, (x, s, b))).numpy()
    for want in (bn_relu_maxpool_pallas(*map(jnp.asarray, (x, s, b))),
                 jax_bn_relu_maxpool_reference(*map(jnp.asarray, (x, s, b)))):
        np.testing.assert_allclose(got, np.asarray(want), **TOL)
    assert np.array_equal(got, bn_relu_maxpool_reference(
        *map(torch.from_numpy, (x, s, b))).numpy())


# --- the unpacked serving slice, float and W8A8 -------------------------


def _decode(row):
    return " ".join(str(int(i)) for i in row)  # title == its id row


@pytest.fixture(scope="module")
def serve_case(tmp_path_factory):
    """A one-video synthetic corpus at 32 px, a tiny frames-stem TwoStream
    in both packages with scores centred on 0.5, tiny Pegasus titles, and
    the JAX calibration of the vision trunk."""
    root = str(tmp_path_factory.mktemp("torch_infer_corpus"))
    paths = make_synth_corpus_on_disk(root, n_videos=1, video_sec=40,
                                      n_chapters=3, hw=HW)
    corpus = VideoCorpus.from_files(paths["img_dir"], paths["data_file"],
                                    paths["vid_file"], paths["subtitle_dir"])
    net = TwoStream(BertModel(BertConfig.tiny()),
                    ResNet(50, n_segment=T, stem_input="frames",
                           stage_sizes=SIZES),
                    segment_size=T, hidden_size=HIDDEN)
    v = _perturb(convert.random_jax_tree(
        net, convert.two_stream_entries(2, SIZES), seed=7),
        np.random.default_rng(7))
    jm = JaxTwoStream(
        lang_model=JaxBertModel(JaxBertConfig.tiny()),
        vision_model=jax_resnet.ResNet(stage_sizes=SIZES, n_segment=T,
                                       tsm_impl="fusedall"),
        segment_size=T, hidden_size=HIDDEN, head_type="mlp")
    s2s = Seq2Seq(Seq2SeqConfig.tiny()).eval()
    s2s_params = convert.random_jax_tree(s2s, convert.seq2seq_entries(
        s2s.cfg), seed=8)
    s2s.load_state_dict(convert.from_jax_seq2seq(s2s_params, s2s.cfg))
    case = dict(corpus=corpus, net=net, v=v, jm=jm, s2s=s2s,
                s2s_params=s2s_params)
    # centre the float scores on 0.5 (as bench_pipeline.py does for random
    # weights) at the midpoint of two neighbours nearest the median that
    # closes a run of positive clips, so that there are cut points and no
    # score lies on the threshold
    from video_chapter_generation_tpu_torch.evalkit.boundary import (
        convert_clip_label2cut_point,
    )

    scores = np.asarray(_port_pipe(case, None).run()[
        corpus.vids[0]].clip_scores)
    srt = np.sort(scores)
    for k in sorted(range(1, len(srt)), key=lambda k: abs(k - len(srt) / 2)):
        mid = float((srt[k - 1] + srt[k]) / 2)
        if convert_clip_label2cut_point(list(scores > mid), T, 2):
            break
    v["params"]["fusion_head"]["head"]["bias"][1] -= np.log(mid / (1 - mid))
    clips = np.stack([_clip(corpus, s) for s in range(0, 24, T)])
    old = jax_resnet.FORCE_WHOLE_BLOCKS
    jax_resnet.FORCE_WHOLE_BLOCKS = True
    try:
        case["jax_scales"] = jax_calibrate_two_stream(jm, v, clips)
    finally:
        jax_resnet.FORCE_WHOLE_BLOCKS = old
    return case


def _clip(corpus, start):
    from video_chapter_generation_tpu_torch.data.frames import load_clip_frames

    vid = corpus.vids[0]
    return load_clip_frames([corpus.frame_path(vid, start + k + 1)
                             for k in range(T)], HW)


def _port_net(case):
    net = case["net"]
    net.load_state_dict(convert.from_jax_two_stream(case["v"], 2, SIZES))
    return net.eval()


def _port_pipe(case, quant):
    scales = None if quant is None else {
        "vision_model": convert.act_scales_from_jax(quant["vision_model"])}
    s2s = case["s2s"]

    def title_fn(ids, mask):
        return generate(s2s, torch.from_numpy(ids).long(),
                        torch.from_numpy(mask), max_len=TITLE_OUT).numpy()

    return ChapterPipeline(
        case["corpus"], make_wordpiece(),
        make_two_stream_score_fn(_port_net(case), CPU, quant_scales=scales),
        title_fn, _decode, clip_frame_num=T, max_text_len=TEXT_LEN,
        title_input_len=TITLE_IN, batch_size=B, score_mode="all", hw=HW,
        title_tokenizer=make_unigram(), device=CPU)


def _jax_pipe(case, quant):
    s2s = JaxSeq2Seq(JaxSeq2SeqConfig.tiny())
    titles = jax.jit(lambda p, i, k: jax_generate(
        s2s, p, i, k, max_len=TITLE_OUT, return_logits=False)[0])
    return JaxChapterPipeline(
        case["corpus"], make_wordpiece(),
        jax_score_fn(case["jm"], case["v"], quant_scales=quant),
        lambda i, k: titles({"params": case["s2s_params"]}, jnp.asarray(i),
                            jnp.asarray(k)),
        _decode, clip_frame_num=T, max_text_len=TEXT_LEN,
        title_input_len=TITLE_IN, batch_size=B, score_mode="all", hw=HW,
        title_tokenizer=make_unigram())


@pytest.mark.parametrize("quant", [False, True], ids=["float", "w8a8"])
def test_unpacked_slice_matches_jax(serve_case, quant, monkeypatch):
    monkeypatch.setattr(jax_resnet, "FORCE_WHOLE_BLOCKS", quant)
    scales = serve_case["jax_scales"] if quant else None
    vid = serve_case["corpus"].vids[0]
    got = _port_pipe(serve_case, scales).run(pipelined=True)[vid]
    want = _jax_pipe(serve_case, scales).run(pipelined=True)[vid]
    tol = 1e-3 if quant else 1e-5
    scores = np.asarray(got.clip_scores)
    assert len(scores) == 9 and np.abs(scores - 0.5).min() > 2 * tol
    np.testing.assert_allclose(scores, want.clip_scores, rtol=0, atol=tol)
    assert got.cut_points and got.cut_points == want.cut_points
    assert got.titles == want.titles and len(got.titles) == len(
        got.cut_points)
    # the score function alone, on one batch of clips
    batch = {"img_clip": np.stack([_clip(serve_case["corpus"], s)
                                   for s in (0, 4, 8, 12)]),
             "text_ids": np.ones((B, TEXT_LEN), np.int32),
             "attention_mask": np.ones((B, TEXT_LEN), np.int32)}
    port_scales = None if scales is None else {
        "vision_model": convert.act_scales_from_jax(scales["vision_model"])}
    p = make_two_stream_score_fn(_port_net(serve_case), CPU,
                                 quant_scales=port_scales)(batch)
    j = jax_score_fn(serve_case["jm"], serve_case["v"],
                     quant_scales=scales)(batch)
    np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=0, atol=tol)


# --- checkpoints, prefetch ------------------------------------------------


@pytest.mark.parametrize("scores", [
    [0.9, 0.1, 0.2, 0.3, 0.4, 0.5],
    [None, 0.3, None, 0.1, 0.7, None, None],
    [0.2, 0.2, None, 0.2, 0.1],
])
def test_checkpoint_retention_matches_orbax(tmp_path, scores):
    ours = CheckpointManager(str(tmp_path / "port"), max_to_keep=3)
    theirs = JaxCheckpointManager(str(tmp_path / "jax"), max_to_keep=3)
    for epoch, score in enumerate(scores):
        state = {"w": np.full((2,), float(epoch), np.float32)}
        ours.save(epoch, {"model": {"w": torch.from_numpy(state["w"])},
                          "step": epoch}, score=score)
        theirs.save(epoch, state, score=score)
        theirs.wait()
    kept = sorted(theirs.manager.all_steps())
    best = theirs.manager.best_step()
    theirs.close()
    assert ours.steps() == kept
    assert ours.best_step() == best
    epoch, state = ours.restore_best()
    assert epoch == best and state["step"] == best


def test_checkpoint_reads_single_file_checkpoints(tmp_path):
    """Checkpoints that hold their metrics inside the .pt (no .json
    beside it) restore by score, and saving on prunes them."""
    ck = CheckpointManager(str(tmp_path), max_to_keep=2)
    for epoch, score in enumerate([0.4, 0.9]):
        torch.save({"epoch": epoch, "state": {"step": epoch},
                    "metrics": {"score": score, "contract": {"e": epoch}}},
                   tmp_path / f"ckpt_{epoch}.pt")
    assert ck.metrics_for(1) == {"score": 0.9, "contract": {"e": 1}}
    assert ck.restore_best() == (1, {"step": 1})
    ck.save(2, {"step": 2}, score=0.5)
    assert ck.steps() == [1, 2] and ck.best_step() == 1
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ckpt_1.pt", "ckpt_2.json", "ckpt_2.pt"]


class _Clips:
    """An InferClipDataset stand-in whose item `bad` raises."""

    def __init__(self, n, bad=None):
        from video_chapter_generation_tpu_torch.data.clip_grid import ClipInfo

        self.all_clip_infos = [ClipInfo.__new__(ClipInfo) for _ in range(n)]
        self.bad = bad

    def __len__(self):
        return len(self.all_clip_infos)

    def __getitem__(self, i):
        if i == self.bad:
            raise RuntimeError(f"cannot decode clip {i}")
        return {"x": np.float32(i)}


def test_score_clips_prefetch_raises_a_failing_batch():
    fn = lambda batch: torch.as_tensor(batch["x"] / 10.0)  # noqa: E731
    plain = score_clips(_Clips(10), fn, batch_size=3, prefetch=0)
    ahead = score_clips(_Clips(10), fn, batch_size=3, prefetch=2)
    assert [c.pred_score for c in ahead] == [c.pred_score for c in plain]
    with pytest.raises(RuntimeError, match="cannot decode clip 7"):
        score_clips(_Clips(10, bad=7), fn, batch_size=3, prefetch=2)


# --- cli/infer_video ------------------------------------------------------


@pytest.fixture(scope="module")
def cli_case(tmp_path_factory):
    """A synthetic corpus (train/val/test), a vocab file, and the port's
    train_segment checkpoint of a tiny frames-stem model."""
    from video_chapter_generation_tpu_torch.data.corpus import (
        VideoCorpus as PortCorpus,
    )
    from video_chapter_generation_tpu_torch.data.synth import (
        make_synth_corpus_on_disk as port_synth,
    )
    from video_chapter_generation_tpu_torch.data.tokenization import (
        WordPieceTokenizer,
    )

    root = tmp_path_factory.mktemp("torch_infer_cli")
    paths = port_synth(str(root / "corpus"), n_videos=6, video_sec=40, hw=64,
                       splits={"train": 4, "val": 1, "test": 1})
    train = PortCorpus.from_files(paths["img_dir"], paths["data_file"],
                                  paths["train_vid_file"],
                                  paths["subtitle_dir"])
    tok = WordPieceTokenizer.build_from_corpus(
        [s["text"] for v in train.vids for s in train.subtitles(v)],
        vocab_size=8000)
    vocab = root / "vocab.txt"
    vocab.write_text("".join(tok.ids_to_tokens[i] + "\n"
                             for i in range(tok.vocab_size)))
    overrides = [f"data.{k}={paths[k]}" for k in (
        "img_dir", "data_file", "subtitle_dir", "train_vid_file",
        "val_vid_file", "test_vid_file")] + [
        "model.kind=two_stream", "model.stem_input=frames",
        "model.compute_dtype=float32", "data.batch_size=2",
        "data.max_text_len=16", "data.clip_frame_num=4",
        f"data.title_input_len={TITLE_IN}",
        f"data.title_decode_len={TITLE_OUT}",
        f"train.ckpt_dir={root}/ckpt", f"train.log_dir={root}/logs"]
    flags = ["--tiny", "--device", "cpu", "--bert_vocab", str(vocab)]
    train_segment.main(overrides + ["train.max_epochs=1"] + flags)
    return root, overrides, flags


def _infer(cli_case, *extra, overrides=()):
    root, base, flags = cli_case
    cwd = os.getcwd()
    os.chdir(root)
    try:
        return infer_video.main(base + list(overrides) + flags + list(extra))
    finally:
        os.chdir(cwd)


def test_infer_video_restores_the_checkpoint(cli_case, capsys):
    results = _infer(cli_case)
    out = capsys.readouterr().out
    assert "restored checkpoint at epoch 0" in out
    assert "random title weights" in out
    lines = [json.loads(line) for line in out.splitlines()
             if line.startswith("{")]
    assert [r["vid"] for r in lines] == list(results)
    for r in results.values():
        assert len(r.titles) == len(r.cut_points)
    root = cli_case[0]
    text = (root / "test_results" / "whole_pipeline_result.txt").read_text()
    assert text.startswith("vid: ")


def test_infer_video_int8_pipelined(cli_case, capsys):
    results = _infer(cli_case, "--int8_vision", "--int8_titles",
                     "--pipelined")
    assert "restored checkpoint" in capsys.readouterr().out
    assert results and all(len(r.titles) == len(r.cut_points)
                           for r in results.values())


def test_infer_video_contract_mismatch_raises(cli_case):
    with pytest.raises(ContractMismatch, match="max_text_len"):
        _infer(cli_case, overrides=["data.max_text_len=20"])


def test_title_restore(tmp_path, capsys):
    """cli/eval_title._restore: a title checkpoint loads; one whose
    contract does not match raises; a checkpoint of another model kind
    leaves the seeded random weights, saying so."""
    from video_chapter_generation_tpu_torch.cli.eval_title import _restore
    from video_chapter_generation_tpu_torch.core.config import Config
    from video_chapter_generation_tpu_torch.train.tasks import TitleGenTask

    cfg = Config().apply_overrides([f"train.ckpt_dir={tmp_path}"])
    task = TitleGenTask(cfg, Seq2SeqConfig.tiny())
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(0, {"model": {}, "step": 0}, metrics={"contract": {
        "model_kind": "two_stream"}})
    init = _restore(cfg, task)
    assert "two_stream checkpoint" in capsys.readouterr().out
    assert init.keys() == task.init_state().keys()
    trained = {k: v + 1 for k, v in init.items()}
    ckpt.save(1, {"model": trained, "step": 5}, score=1.0,
              metrics={"contract": task.contract})
    got = _restore(cfg, task)
    assert all(torch.equal(got[k], trained[k]) for k in trained)
    ckpt.save(2, {"model": trained, "step": 9}, score=2.0, metrics={
        "contract": dict(task.contract, vocab_size=3)})
    with pytest.raises(ContractMismatch, match="vocab_size"):
        _restore(cfg, task)


@pytest.mark.parametrize("extra", [
    ["--num_beams", "4", "--sharded", "model.kind=two_stream_window"],
    ["--vision_emb_dir", "embs", "--sharded",
     "model.kind=two_stream_window"],
    ["--fusion_type", "mlp", "model.kind=two_stream_window", "--sharded"],
    ["--sharded", "model.kind=two_stream_window"],
    ["--title_arch", "bigbird", "--num_beams", "4",
     "model.kind=two_stream_window"],
    ["--title_arch", "bart", "--sharded", "model.kind=two_stream_window"],
    ["model.kind=two_stream_window"],
    ["--sharded", "--int8_titles", "model.kind=two_stream_window"]])
def test_infer_video_names_what_is_not_ported(cli_case, extra):
    """The window model is the one thing the CLI does not serve; it names
    the JAX package's fault (its infer_video cannot serve it either).
    Beams, vision-conditioned titles, the text-only boundary model and
    --sharded are served (tests/test_torch_beam_search.py,
    tests/test_torch_vision_titles.py, tests/test_torch_text_task.py,
    test_infer_video_sharded_equals_unsharded); beside the window model,
    they are refused all the same."""
    overrides = [e for e in extra if "=" in e]
    flags = [e for e in extra if "=" not in e]
    with pytest.raises(SystemExit, match="ROADMAP (queue 1 item|lists this "
                       "under the JAX package's faults)"):
        _infer(cli_case, *flags, overrides=overrides)


@pytest.mark.parametrize("extra", [["--pipelined"], [
    "--int8_vision", "--int8_titles", "--pipelined"]],
    ids=["pipelined", "int8"])
def test_infer_video_sharded_equals_unsharded(cli_case, capsys, extra):
    """--sharded on the CPU: two CPU shards (a row each at
    data.batch_size=2), a replica of each model a shard device (one
    here), the title rows padded and split; pipelined in float32, and
    W8A8 with int8 titles (the calibrated scales on each shard). The
    cut points, titles and clip scores equal the unsharded run's (the
    scores within 1e-6: the CPU GEMMs run one row a shard, not two, and
    may sum in another order)."""
    plain = _infer(cli_case, *extra)
    sharded = _infer(cli_case, "--sharded", *extra)
    assert "restored checkpoint at epoch 0" in capsys.readouterr().out
    assert list(sharded) == list(plain)
    for vid, r in plain.items():
        s = sharded[vid]
        assert s.cut_points == r.cut_points and s.titles == r.titles
        np.testing.assert_allclose(s.clip_scores, r.clip_scores, rtol=0,
                                   atol=1e-6)
    bad = cli_case[1] + ["data.batch_size=3"]
    with pytest.raises(SystemExit, match="not divisible"):
        _infer(cli_case, "--sharded", overrides=bad[-1:])


def test_infer_video_two_processes_only_the_first_writes(cli_case,
                                                         tmp_path):
    """cli/infer_video under a launcher's environment, two processes on
    gloo (--sharded, the CPU): each serves vids[rank::2], the first prints
    the merged JSON lines and writes the result file, the second neither
    (the JAX CLI has every process write the same file). The lines equal
    a one-process run's. The test split holds one video, so the second
    process serves none: it scores nothing (the JAX fan-out would serve
    the whole corpus there, ChapterPipeline.run reading [] as all)."""
    import socket
    import subprocess
    import sys
    from pathlib import Path

    root, base, flags = cli_case
    argv = base + flags + ["--sharded"]
    single = _infer(cli_case, "--sharded")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    repo = str(Path(__file__).resolve().parents[1])
    procs = []
    for rank in (0, 1):
        (tmp_path / f"r{rank}").mkdir()
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("JAX_", "XLA_"))}
        env.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE="2", MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   CUDA_VISIBLE_DEVICES="", PYTHONPATH=repo)
        procs.append(subprocess.Popen(
            [sys.executable, "-m",
             "video_chapter_generation_tpu_torch.cli.infer_video", *argv],
            cwd=tmp_path / f"r{rank}", env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
    vids = list(single)
    for rank, out in enumerate(outs):
        assert (f"process {rank} of 2 (backend gloo, cpu, mesh "
                f"{{'data': 2, 'model': 1}}) serves "
                f"{json.dumps(vids[rank::2])}") in out, out
    lines = [json.loads(x) for x in outs[0].splitlines()
             if x.startswith('{"vid"')]
    assert [x["vid"] for x in lines] == vids
    for x in lines:
        r = single[x["vid"]]
        assert x["cut_points"] == r.cut_points and x["titles"] == r.titles
    assert not any(x.startswith('{"vid"') for x in outs[1].splitlines())
    assert vids[1::2] == [] and "stage seconds: {}" in outs[1]
    assert (tmp_path / "r0" / "test_results" /
            "whole_pipeline_result.txt").is_file()
    assert not (tmp_path / "r1" / "test_results").exists()
