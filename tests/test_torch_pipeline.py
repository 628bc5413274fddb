"""The port's serving slice as a whole against the JAX package, on the CPU.

One 40-s synthetic video (real JPEGs at 64 px, decoded into a uint8 s2d
pack) goes through the JAX ChapterPipeline(frame_pack=True) with
make_packed_two_stream_score_fn and tiny greedy titles, and through the
port's pipeline with the same weights carried over by models/convert.py.
Clip scores agree to 1e-4 (float32 on both sides, different summation
orders); the head bias is shifted so scores straddle 0.5 and no score
lies within 1e-3 of it, so labels, cut points and title id rows must be
equal.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fixtures import make_unigram, make_wordpiece
from test_torch_models import (
    T,
    jax_two_stream,
    port_two_stream,
    random_two_stream_variables,
)

from video_chapter_generation_tpu.data.corpus import VideoCorpus
from video_chapter_generation_tpu.data.native_loader import space_to_depth4
from video_chapter_generation_tpu.data.synth import make_synth_corpus_on_disk
from video_chapter_generation_tpu.models.seq2seq import (
    Seq2Seq as JaxSeq2Seq,
    Seq2SeqConfig as JaxSeq2SeqConfig,
    generate as jax_generate,
)
from video_chapter_generation_tpu.pipeline import (
    ChapterPipeline as JaxChapterPipeline,
    bucket_title_fn as jax_bucket_title_fn,
    make_packed_two_stream_score_fn as jax_packed_score_fn,
)
from video_chapter_generation_tpu_torch.models import convert
from video_chapter_generation_tpu_torch.models.seq2seq import (
    Seq2Seq,
    Seq2SeqConfig,
    generate,
)
from video_chapter_generation_tpu_torch.pipeline import (
    ChapterPipeline,
    bucket_title_fn,
    make_packed_two_stream_score_fn,
)

HW, TEXT_LEN, TITLE_IN, TITLE_OUT, BATCH, BUCKET = 64, 16, 24, 6, 4, 2
CPU = torch.device("cpu")


def _decode(row):
    return " ".join(str(int(i)) for i in row)  # title == its id row


def _port_pipe(corpus, variables, s2s, frame_pack=True):
    packed_score = make_packed_two_stream_score_fn(port_two_stream(variables),
                                                   CPU)

    def stacked_score(batch):  # per-clip frames [B, T, hw, hw, 3]
        imgs = batch["img_clip"]
        b, t = imgs.shape[:2]
        pack = torch.from_numpy(space_to_depth4(imgs.reshape(-1, HW, HW, 3)))
        idx = np.arange(b * t, dtype=np.int32).reshape(b, t)
        return packed_score({**batch, "frame_idx": idx}, pack)

    def title_fn(ids, mask):
        return generate(s2s, torch.from_numpy(ids).long(),
                        torch.from_numpy(mask), max_len=TITLE_OUT).numpy()

    return ChapterPipeline(
        corpus, make_wordpiece(), packed_score if frame_pack else stacked_score,
        bucket_title_fn(title_fn, BUCKET), _decode, clip_frame_num=T,
        max_text_len=TEXT_LEN, title_input_len=TITLE_IN, batch_size=BATCH,
        score_mode="all", hw=HW, title_tokenizer=make_unigram(),
        frame_pack=frame_pack, device=CPU)


def _jax_pipe(corpus, variables, s2s_params):
    s2s = JaxSeq2Seq(JaxSeq2SeqConfig.tiny())
    titles = jax.jit(lambda v, i, k: jax_generate(
        s2s, v, i, k, max_len=TITLE_OUT, return_logits=False)[0])
    title_fn = jax_bucket_title_fn(
        lambda i, k: titles({"params": s2s_params}, jnp.asarray(i),
                            jnp.asarray(k)), BUCKET)
    return JaxChapterPipeline(
        corpus, make_wordpiece(),
        jax_packed_score_fn(jax_two_stream(), variables), title_fn, _decode,
        clip_frame_num=T, max_text_len=TEXT_LEN, title_input_len=TITLE_IN,
        batch_size=BATCH, score_mode="all", hw=HW,
        title_tokenizer=make_unigram(), frame_pack=True)


@pytest.fixture(scope="module")
def slice_case(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_slice_corpus"))
    paths = make_synth_corpus_on_disk(root, n_videos=1, video_sec=40,
                                      n_chapters=3, hw=HW)
    corpus = VideoCorpus.from_files(paths["img_dir"], paths["data_file"],
                                    paths["vid_file"], paths["subtitle_dir"])
    s2s = Seq2Seq(Seq2SeqConfig.tiny()).eval()
    s2s_params = convert.random_jax_tree(
        s2s, convert.seq2seq_entries(s2s.cfg), seed=5)
    s2s.load_state_dict(convert.from_jax_seq2seq(s2s_params, s2s.cfg))
    variables = random_two_stream_variables(6)
    # centre the scores on 0.5 (as bench_pipeline.py does for random
    # weights), so there are cut points and titles to compare; the centre
    # is the midpoint of two neighbouring scores, so no score lands on it
    vid = corpus.vids[0]
    first = np.sort(_port_pipe(corpus, variables, s2s).run()[vid].clip_scores)
    med = float((first[3] + first[4]) / 2)
    variables["params"]["fusion_head"]["head"]["bias"][1] -= np.log(
        med / (1 - med))
    return corpus, variables, s2s_params, s2s


def test_slice_matches_jax(slice_case):
    corpus, variables, s2s_params, s2s = slice_case
    vid = corpus.vids[0]
    got = _port_pipe(corpus, variables, s2s).run(pipelined=True)[vid]
    want = _jax_pipe(corpus, variables, s2s_params).run(pipelined=True)[vid]

    scores = np.asarray(got.clip_scores)
    assert len(scores) == 9 and np.abs(scores - 0.5).min() > 1e-3
    np.testing.assert_allclose(scores, want.clip_scores, rtol=1e-4,
                               atol=1e-4)
    assert got.cut_points and got.cut_points == want.cut_points
    assert got.spans == want.spans
    assert len(got.titles) == len(got.cut_points)
    assert got.titles == want.titles


def test_pipelined_and_stacked_equal_packed(slice_case):
    """Sequential, two-in-flight, and per-clip stacked frames (the plain
    path, frame_pack=False) give the same scores and titles: the gather
    happens before the model, so all three run the same compute."""
    corpus, variables, _, s2s = slice_case
    pipe = _port_pipe(corpus, variables, s2s)
    seq = pipe.run()
    piped = pipe.run(pipelined=True)
    stacked = _port_pipe(corpus, variables, s2s, frame_pack=False).run()
    for vid in corpus.vids:
        assert seq[vid].titles
        for other in (piped, stacked):
            assert other[vid].clip_scores == seq[vid].clip_scores
            assert other[vid].titles == seq[vid].titles
    assert pipe.videos_per_minute() > 0


def test_bucket_title_fn_pads_and_trims():
    calls = []

    def raw(ids, mask):
        calls.append(ids.shape[0])
        return ids[:, :2]

    fn = bucket_title_fn(raw, multiple=8)
    ids = np.arange(90).reshape(9, 10)
    out = fn(ids, np.ones_like(ids))
    assert calls == [8, 8] and out.shape == (9, 2)
    np.testing.assert_array_equal(out, ids[:, :2])
