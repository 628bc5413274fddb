"""The port's own copies of the JAX package's host-side modules against
the originals, on the same inputs (a synthetic corpus on disk): clip
grids, corpus records, training and inference dataset items, tokenizers,
collate and the loader, cut points, config overrides, the checkpoint
contract, the vision-embedding block selection, provider and
attachment, the boundary metrics, ROUGE, the segment and title
evaluation with their result files and the clips-JSON flatten. All must
be equal, not close: the copies are the same code."""

from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from video_chapter_generation_tpu.core import config as jax_config
from video_chapter_generation_tpu.core import contract as jax_contract
from video_chapter_generation_tpu.data import clip_grid as jax_clip_grid
from video_chapter_generation_tpu.data import corpus as jax_corpus
from video_chapter_generation_tpu.data import datasets as jax_datasets
from video_chapter_generation_tpu.data import loader as jax_loader
from video_chapter_generation_tpu.data import synth as jax_synth
from video_chapter_generation_tpu.data import tokenization as jax_tok
from video_chapter_generation_tpu.evalkit import boundary as jax_boundary
from video_chapter_generation_tpu.datasetkit import flatten as jax_flatten
from video_chapter_generation_tpu.evalkit import metrics as jax_metrics
from video_chapter_generation_tpu.evalkit import rouge as jax_rouge
from video_chapter_generation_tpu.evalkit import (
    segment_eval as jax_segment_eval,
)
from video_chapter_generation_tpu.evalkit import title_eval as jax_title_eval
from video_chapter_generation_tpu_torch.core import config, contract
from video_chapter_generation_tpu_torch.data import (
    clip_grid,
    corpus,
    datasets,
    loader,
    synth,
    tokenization,
)
from video_chapter_generation_tpu_torch.datasetkit import flatten
from video_chapter_generation_tpu_torch.evalkit import (
    boundary,
    metrics,
    rouge,
    segment_eval,
    title_eval,
)


@pytest.fixture(scope="module")
def disk(tmp_path_factory):
    """The same synthetic corpus written by both copies of data/synth.py."""
    kw = dict(n_videos=3, video_sec=40, hw=32, splits={"train": 3})
    a = synth.make_synth_corpus_on_disk(
        str(tmp_path_factory.mktemp("port")), **kw)
    b = jax_synth.make_synth_corpus_on_disk(
        str(tmp_path_factory.mktemp("jax")), **kw)
    return a, b


def _corpora(disk):
    a, b = disk
    return (corpus.VideoCorpus.from_files(a["img_dir"], a["data_file"],
                                          a["train_vid_file"],
                                          a["subtitle_dir"]),
            jax_corpus.VideoCorpus.from_files(b["img_dir"], b["data_file"],
                                              b["train_vid_file"],
                                              b["subtitle_dir"]))


def _texts(c):
    return [s["text"] for vid in c.vids for s in c.subtitles(vid)]


def _same(a, b):
    """Deep equality over dicts, sequences, arrays and dataclasses."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif hasattr(a, "__dataclass_fields__"):
        _same(vars(a), vars(b))
    else:
        assert a == b


def _rel(path, root):
    return path.replace(root, "")


def test_synth_corpus_files_match(disk):
    a, b = disk
    pa, pb = _corpora(disk)
    assert pa.vids == pb.vids
    for vid in pa.vids:
        assert pa.subtitles(vid) == pb.subtitles(vid)
        assert pa.raw_cut_secs(vid) == pb.raw_cut_secs(vid)
        assert pa.image_num(vid) == pb.image_num(vid)
        _same(vars(pa.records[vid]), vars(pb.records[vid]))
    frame = pa.frame_path(pa.vids[0], 3)
    assert open(frame, "rb").read() == open(
        pb.frame_path(pb.vids[0], 3), "rb").read()


def test_clip_grid_matches(disk):
    pa, pb = _corpora(disk)
    for vid in pa.vids:
        ca = clip_grid.flatten_video_to_clips(
            vid, pa.img_dir, pa.image_num(vid), pa.raw_cut_secs(vid),
            pa.subtitles(vid), 8)
        cb = jax_clip_grid.flatten_video_to_clips(
            vid, pb.img_dir, pb.image_num(vid), pb.raw_cut_secs(vid),
            pb.subtitles(vid), 8)
        assert len(ca) == len(cb)
        for x, y in zip(ca, cb):
            da, db = vars(x).copy(), vars(y).copy()
            da["image_paths"] = [_rel(p, pa.img_dir) for p in da["image_paths"]]
            db["image_paths"] = [_rel(p, pb.img_dir) for p in db["image_paths"]]
            _same(da, db)
        assert clip_grid.chapter_spans([4, 9], 20) == \
            jax_clip_grid.chapter_spans([4, 9], 20)


@pytest.mark.parametrize("kind", ["wordpiece", "unigram"])
def test_tokenizers_match(disk, kind):
    pa, pb = _corpora(disk)
    cls_a, cls_b = {"wordpiece": (tokenization.WordPieceTokenizer,
                                  jax_tok.WordPieceTokenizer),
                    "unigram": (tokenization.UnigramTokenizer,
                                jax_tok.UnigramTokenizer)}[kind]
    ta = cls_a.build_from_corpus(_texts(pa), vocab_size=300)
    tb = cls_b.build_from_corpus(_texts(pb), vocab_size=300)
    assert ta.vocab_size == tb.vocab_size
    for text in _texts(pa)[:20] + ["Hello, World! okay moving on"]:
        toks = ta.tokenize(text)
        assert toks == tb.tokenize(text)
        assert ta.convert_tokens_to_ids(toks) == tb.convert_tokens_to_ids(toks)
    assert contract.vocab_hash(ta) == jax_contract.vocab_hash(tb)


@pytest.mark.parametrize("s2d", [False, True])
def test_clip_dataset_items_and_loader_match(disk, s2d):
    pa, pb = _corpora(disk)
    tok_a = tokenization.WordPieceTokenizer.build_from_corpus(_texts(pa), 300)
    tok_b = jax_tok.WordPieceTokenizer.build_from_corpus(_texts(pb), 300)
    da = datasets.ClipDataset(pa, tok_a, 8, 16, hw=32, s2d=s2d)
    db = jax_datasets.ClipDataset(pb, tok_b, 8, 16, hw=32, s2d=s2d)
    for epoch in range(2):
        for i in range(len(da)):
            _same(da.__getitem__(i, epoch), db.__getitem__(i, epoch))
    la = loader.DataLoader(da, 2, seed=5, prefetch=0)
    lb = jax_loader.DataLoader(db, 2, seed=5, prefetch=0)
    for ba, bb in zip(la(1), lb(1)):
        _same(ba, bb)
    items = [da[0], da[1]]
    _same(loader.collate(items), jax_loader.collate(items))


def test_infer_dataset_and_chapter_text_match(disk):
    pa, pb = _corpora(disk)
    tok_a = tokenization.WordPieceTokenizer.build_from_corpus(_texts(pa), 300)
    tok_b = jax_tok.WordPieceTokenizer.build_from_corpus(_texts(pb), 300)
    vid = pa.vids[1]
    clips_a = clip_grid.flatten_video_to_clips(
        vid, pa.img_dir, pa.image_num(vid), pa.raw_cut_secs(vid),
        pa.subtitles(vid), 8)
    clips_b = jax_clip_grid.flatten_video_to_clips(
        vid, pb.img_dir, pb.image_num(vid), pb.raw_cut_secs(vid),
        pb.subtitles(vid), 8)
    ia = datasets.InferClipDataset(clips_a, tok_a, 16, hw=32)
    ib = jax_datasets.InferClipDataset(clips_b, tok_b, 16, hw=32)
    for i in (0, len(ia) - 1):
        _same(ia[i], ib[i])
    subs = pa.subtitles(vid)
    assert datasets._chapter_text(subs, 3, 25) == \
        jax_datasets._chapter_text(subs, 3, 25)


def test_cut_points_and_config_match():
    rng = np.random.default_rng(0)
    for _ in range(5):
        labels = list(rng.integers(0, 2, 60))
        assert boundary.convert_clip_label2cut_point(labels, 16, 2) == \
            jax_boundary.convert_clip_label2cut_point(labels, 16, 2)
    ov = ["data.batch_size=8", "model.kind=two_stream", "optim.betas=[0.8,0.9]"]
    assert config.Config().apply_overrides(ov).to_dict() == \
        jax_config.Config().apply_overrides(ov).to_dict()


@pytest.mark.parametrize("s2d", [False, True])
def test_window_dataset_items_match(disk, s2d):
    pa, pb = _corpora(disk)
    tok_a = tokenization.WordPieceTokenizer.build_from_corpus(_texts(pa), 300)
    tok_b = jax_tok.WordPieceTokenizer.build_from_corpus(_texts(pb), 300)
    da = datasets.WindowClipDataset(pa, tok_a, 8, 16, 1, hw=32, s2d=s2d)
    db = jax_datasets.WindowClipDataset(pb, tok_b, 8, 16, 1, hw=32, s2d=s2d)
    for epoch in range(2):
        for i in range(len(da)):
            _same(da.__getitem__(i, epoch), db.__getitem__(i, epoch))
    for target in (0, 3, 9):
        for n, w, skip in ((10, 1, 2), (4, 2, 1)):
            assert clip_grid.window_clip_indices(target, n, w, skip) == \
                jax_clip_grid.window_clip_indices(target, n, w, skip)
    assert clip_grid.window_skip_size(16) == jax_clip_grid.window_skip_size(16)


def test_infer_window_dataset_matches(disk):
    pa, pb = _corpora(disk)
    tok_a = tokenization.WordPieceTokenizer.build_from_corpus(_texts(pa), 300)
    tok_b = jax_tok.WordPieceTokenizer.build_from_corpus(_texts(pb), 300)
    clips_a, clips_b = [], []
    for vid in pa.vids[:2]:  # two videos: the window stops at each edge
        clips_a += clip_grid.flatten_video_to_clips(
            vid, pa.img_dir, pa.image_num(vid), pa.raw_cut_secs(vid),
            pa.subtitles(vid), 8)
        clips_b += jax_clip_grid.flatten_video_to_clips(
            vid, pb.img_dir, pb.image_num(vid), pb.raw_cut_secs(vid),
            pb.subtitles(vid), 8)
    ia = datasets.InferWindowClipDataset(clips_a, tok_a, 8, 16, 1, hw=32)
    ib = jax_datasets.InferWindowClipDataset(clips_b, tok_b, 8, 16, 1, hw=32)
    assert ia.vid_to_range == ib.vid_to_range
    for i in range(len(ia)):
        _same(ia[i], ib[i])


def test_ranking_metrics_match():
    rng = np.random.default_rng(1)
    for _ in range(5):
        y = rng.integers(0, 2, 40)
        s = np.round(rng.random(40), 1)  # ties
        assert metrics.roc_auc_score(y, s) == jax_metrics.roc_auc_score(y, s)
        assert metrics.average_precision_score(y, s) == \
            jax_metrics.average_precision_score(y, s)
    with pytest.raises(ValueError):
        metrics.roc_auc_score([1, 1], [0.2, 0.3])


def test_vision_emb_block_range_matches():
    for start, end in [(0, 40), (3, 17), (16, 30), (0, 10), (50, 52),
                       (7, 200), (33, 70)]:
        for block in (16, 8):
            assert datasets.vision_emb_block_range(start, end, block) == \
                jax_datasets.vision_emb_block_range(start, end, block)


def test_vision_emb_provider_and_attachment_match(tmp_path):
    """The npy provider reads the same blocks (a missing one skipped), and
    chapter_vision_embs is the attachment of the JAX _VisionEmbMixin, with
    [T, D] blocks, [D] ones, more blocks than max_vision_emb and none."""
    rng = np.random.default_rng(2)
    vid = "vid0"
    (tmp_path / vid).mkdir()
    for st in (0, 16, 48, 64):  # no 32
        np.save(tmp_path / vid / f"vision_emb_{st}_{st + 16}.npy",
                rng.standard_normal((16, 6)).astype(np.float32))
    pa = datasets.npy_vision_emb_provider(str(tmp_path))
    pb = jax_datasets.npy_vision_emb_provider(str(tmp_path))
    for span in [(0, 80), (0, 40), (20, 90), (70, 72)]:
        _same(pa(vid, *span), pb(vid, *span))

    def jax_attach(embs, n, dim):
        host = SimpleNamespace(emb_provider=lambda *a: embs,
                               max_vision_emb=n, emb_dim=dim)
        out = jax_datasets._VisionEmbMixin._attach_vision(
            host, {"chapter_start": 0, "chapter_end": 80}, vid)
        return out["vision_embs"], out["vision_attention_mask"]

    blocks = pa(vid, 0, 80)
    for embs, n in [(blocks, 10), (blocks, 2), ([], 3),
                    ([b.mean(0) for b in blocks], 5)]:
        _same(datasets.chapter_vision_embs(embs, n, 6),
              jax_attach(embs, n, 6))


def test_native_loader_branches_match(disk):
    """load_clip_frames with a native decode function installed (JAX
    data/frames.py:29-67): frames and the s2d pack come from it, a frame
    cache keeps the PIL path, and uninstalling restores PIL; the same
    on both copies. space_to_depth4 equals the JAX native_loader's."""
    from video_chapter_generation_tpu.data import frames as jax_frames
    from video_chapter_generation_tpu.data import native_loader as jax_nl
    from video_chapter_generation_tpu_torch.data import frames

    a, _ = disk
    paths = sorted(str(p) for p in Path(a["img_dir"]).rglob("*.jpg"))[:4]

    def fake(ps, hw):
        return np.full((len(ps), hw, hw, 3), len(ps), np.uint8)

    fake.s2d = lambda ps, hw: np.full((len(ps), hw // 4, hw // 4, 48), 9,
                                      np.uint8)
    try:
        for mod in (frames, jax_frames):
            mod.set_native_loader(fake)
        for s2d in (False, True):
            _same(frames.load_clip_frames(paths, 32, s2d=s2d),
                  jax_frames.load_clip_frames(paths, 32, s2d=s2d))
        got = frames.load_clip_frames(paths, 32, cache=frames.FrameCache())
        _same(got, jax_frames.load_clip_frames(
            paths, 32, cache=jax_frames.FrameCache()))
        assert not (got == len(paths)).all()  # decoded, not the fake's
    finally:
        for mod in (frames, jax_frames):
            mod.set_native_loader(None)
    pil = frames.load_clip_frames(paths, 32)
    _same(pil, jax_frames.load_clip_frames(paths, 32))
    _same(frames.space_to_depth4(pil), jax_nl.space_to_depth4(pil))


WORDS = ["the", "cat", "sat", "on", "mat", "a", "dog", "ran", "intro",
         "part", "two", "", "end"]


def _sentence(rng, lo=0, hi=14):
    """A random sentence over a small vocabulary: repeats, empty words
    (double spaces) and empty sentences included."""
    return " ".join(rng.choice(WORDS, int(rng.integers(lo, hi))))


def test_boundary_metrics_match():
    rng = np.random.default_rng(2)
    for _ in range(60):
        gt = sorted(rng.choice(200, int(rng.integers(1, 6)), replace=False))
        pred = sorted(rng.choice(200, int(rng.integers(0, 8)),
                                 replace=False))
        assert boundary.calculate_pr(gt, pred) == \
            jax_boundary.calculate_pr(gt, pred)
        p, r = rng.random(2) * (rng.random() < 0.9)
        assert boundary.f1(p, r) == jax_boundary.f1(p, r)
    per_video = [(sorted(rng.choice(100, int(rng.integers(0, 4)),
                                    replace=False)),
                  sorted(rng.choice(100, int(rng.integers(0, 5)),
                                    replace=False))) for _ in range(12)]
    assert boundary.aggregate_pr_over_videos(per_video) == \
        jax_boundary.aggregate_pr_over_videos(per_video)
    for seed in range(5):
        args = (int(rng.integers(5, 80)), float(rng.random()), 16, 2)
        assert boundary.random_guess_cut_points(
            *args, np.random.default_rng(seed)) == \
            jax_boundary.random_guess_cut_points(
                *args, np.random.default_rng(seed))
    with pytest.raises(ZeroDivisionError):
        boundary.calculate_pr([], [3])


def test_rouge_matches():
    rng = np.random.default_rng(3)
    hyps = [_sentence(rng) for _ in range(80)]
    refs = [_sentence(rng) for _ in range(80)]
    for h, r in zip(hyps, refs):
        assert rouge.rouge_scores(h, r) == jax_rouge.rouge_scores(h, r)
    assert rouge.rouge_scores_avg(hyps, refs) == \
        jax_rouge.rouge_scores_avg(hyps, refs)
    assert rouge.rouge_scores_avg([], []) == jax_rouge.rouge_scores_avg([], [])


def _scored_clips(mod, rng_seed, n_videos=4):
    """Random scored ClipInfos of the given module, video-contiguous."""
    rng = np.random.default_rng(rng_seed)
    out = []
    for v in range(n_videos):
        n = int(rng.integers(3, 25))
        labels = (rng.random(n) < 0.3).astype(int)
        cuts = sorted(rng.choice(4 * n, int(rng.integers(0, 4)),
                                 replace=False).tolist())
        for k in range(n):
            score = float(np.round(rng.random(), 2))
            out.append(mod.ClipInfo(
                image_paths=[], text_clip="", clip_label=int(labels[k]),
                clip_start_end=(4 * k, 4 * k + 16), cut_points=cuts,
                vid=f"v{v}", pred_score=score, pred_label=int(score >= 0.5)))
    return out


@pytest.mark.parametrize("compat", [False, True])
def test_segment_eval_and_result_files_match(tmp_path, compat):
    for seed in range(4):
        got = segment_eval.evaluate_segment_predictions(
            _scored_clips(segment_eval, seed), 16, 2,
            rng=np.random.default_rng(seed),
            compat_first_clip_double_count=compat)
        want = jax_segment_eval.evaluate_segment_predictions(
            _scored_clips(jax_segment_eval, seed), 16, 2,
            rng=np.random.default_rng(seed),
            compat_first_clip_double_count=compat)
        assert got == want
    assert segment_eval.group_clips_by_video(_scored_clips(segment_eval, 0)
                                             ).keys() == \
        jax_segment_eval.group_clips_by_video(
            _scored_clips(jax_segment_eval, 0)).keys()
    segment_eval.write_segment_result_files(
        got, str(tmp_path / "p" / "r.txt"), str(tmp_path / "p" / "c.json"))
    jax_segment_eval.write_segment_result_files(
        want, str(tmp_path / "j" / "r.txt"), str(tmp_path / "j" / "c.json"))
    for name in ("r.txt", "c.json"):
        assert (tmp_path / "p" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes()


def test_title_eval_and_result_file_match(tmp_path):
    rng = np.random.default_rng(4)
    src = [_sentence(rng, 0, 60) for _ in range(20)]
    gen = [_sentence(rng, 0, 8) for _ in range(20)]
    gt = [_sentence(rng, 1, 8) for _ in range(20)]
    for text in src[:5]:
        assert title_eval.lead_baseline(text) == \
            jax_title_eval.lead_baseline(text)
        assert title_eval.principal_baseline(text) == \
            jax_title_eval.principal_baseline(text)
        assert title_eval.random_baseline(text, np.random.default_rng(1)) == \
            jax_title_eval.random_baseline(text, np.random.default_rng(1))
    got = title_eval.evaluate_titles(gen, gt, src, 1.5, 0.25, seed=9)
    want = jax_title_eval.evaluate_titles(gen, gt, src, 1.5, 0.25, seed=9)
    assert got == want
    assert title_eval.evaluate_titles([""], [""], [""]) == \
        jax_title_eval.evaluate_titles([""], [""], [""])
    title_eval.write_title_result_file(got, str(tmp_path / "p" / "t.txt"))
    jax_title_eval.write_title_result_file(want, str(tmp_path / "j" / "t.txt"))
    assert (tmp_path / "p" / "t.txt").read_bytes() == \
        (tmp_path / "j" / "t.txt").read_bytes()


def test_flatten_matches(disk, tmp_path, capsys):
    a, b = disk
    pa, pb = _corpora(disk)
    ga, gb = flatten.flatten_corpus(pa, 8), jax_flatten.flatten_corpus(pb, 8)
    assert len(ga) == len(gb) > 0
    for x, y in zip(ga, gb):
        x, y = dict(x), dict(y)
        x["image_paths"] = [_rel(p, pa.img_dir) for p in x["image_paths"]]
        y["image_paths"] = [_rel(p, pb.img_dir) for p in y["image_paths"]]
        assert x == y
    argv = ["--img_dir", a["img_dir"], "--data_file", a["data_file"],
            "--vid_file", a["train_vid_file"], "--subtitle_dir",
            a["subtitle_dir"], "--clip_frame_num", "8", "--fps", "1"]
    flatten.main(argv + ["--out", str(tmp_path / "p.json")])
    jax_flatten.main(argv + ["--out", str(tmp_path / "j.json")])
    out = capsys.readouterr().out.splitlines()
    assert out[0].replace("p.json", "j.json") == out[1]
    assert (tmp_path / "p.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()


def test_glove_copies_match(disk, tmp_path):
    """datasetkit/glove.py's copies: the text loader (a malformed line
    skipped), the pickle round trip, embed_tokens and build_word_vocab,
    and text_decontracted beside them."""
    from video_chapter_generation_tpu.datasetkit import glove as jax_glove
    from video_chapter_generation_tpu.datasetkit import (
        parsing as jax_parsing,
    )
    from video_chapter_generation_tpu_torch.datasetkit import glove, parsing

    rng = np.random.default_rng(0)
    words = ["the", "cat", "sat"]
    path = tmp_path / "g.txt"
    path.write_text("".join(
        w + " " + " ".join(f"{v:.5f}" for v in rng.standard_normal(4))
        + "\n" for w in words) + "bad x y\n")
    table = glove.load_glove_txt(str(path))
    _same(table, jax_glove.load_glove_txt(str(path)))
    glove.save_glove_pickle(table, str(tmp_path / "a.pkl"))
    jax_glove.save_glove_pickle(table, str(tmp_path / "b.pkl"))
    _same(glove.load_glove_pickle(str(tmp_path / "b.pkl")),
          jax_glove.load_glove_pickle(str(tmp_path / "a.pkl")))
    toks = ["cat", "dog", "the"]
    _same(glove.embed_tokens(toks, table, 3),
          jax_glove.embed_tokens(toks, table, 3))
    pa, pb = _corpora(disk)
    _same(glove.build_word_vocab(pa), jax_glove.build_word_vocab(pb))
    for s in ("won't stop, can't see; let's go", "it's they're I'd we'll "
              "you've I'm isn't"):
        assert parsing.text_decontracted(s) == \
            jax_parsing.text_decontracted(s)


@pytest.mark.parametrize("glove_items", [False, True])
def test_gpt_datasets_match(disk, glove_items):
    """GloveSubtitleDataset and WordIdSubtitleDataset items: the same
    random 16 s window and stream per epoch."""
    from video_chapter_generation_tpu_torch.datasetkit.glove import (
        build_word_vocab,
    )

    pa, pb = _corpora(disk)
    vocab = build_word_vocab(pa)
    rng = np.random.default_rng(1)
    table = {w: rng.standard_normal(8).astype(np.float32)
             for w in vocab[::2]}
    if glove_items:
        a = datasets.GloveSubtitleDataset(pa, table, vocab, max_text_len=20,
                                          emb_dim=8, seed=5)
        b = jax_datasets.GloveSubtitleDataset(pb, table, vocab,
                                              max_text_len=20, emb_dim=8,
                                              seed=5)
    else:
        a = datasets.WordIdSubtitleDataset(pa, vocab, max_text_len=20, seed=5)
        b = jax_datasets.WordIdSubtitleDataset(pb, vocab, max_text_len=20,
                                               seed=5)
    assert len(a) == len(b)
    moved = False
    for epoch in range(3):
        for i in range(len(a)):
            x, y = a.__getitem__(i, epoch), b.__getitem__(i, epoch)
            _same(x, y)
            moved |= bool((x["targets"] != -1).any())
    assert moved


@pytest.mark.parametrize("name", ["ListwiseSlateDataset",
                                  "ContrastiveSubtitleDataset",
                                  "AllClipDataset"])
def test_text_training_datasets_match(disk, name):
    """The slate, MoCo-pair and all-clip samplers of the contrastive and
    listwise text training: the same items per epoch."""
    pa, pb = _corpora(disk)
    ta = tokenization.WordPieceTokenizer.build_from_corpus(_texts(pa), 200)
    tb = jax_tok.WordPieceTokenizer.build_from_corpus(_texts(pb), 200)
    kw = {"ListwiseSlateDataset": dict(clip_frame_num=8, max_text_len=16,
                                       num_negatives=3, seed=5),
          "ContrastiveSubtitleDataset": dict(num_candidates=3,
                                             max_text_len=16, seed=5),
          "AllClipDataset": dict(clip_frame_num=8, max_text_len=16,
                                 max_clips=6, seed=5)}[name]
    a = getattr(datasets, name)(pa, ta, **kw)
    b = getattr(jax_datasets, name)(pb, tb, **kw)
    assert len(a) == len(b)
    for epoch in range(2):
        for i in range(len(a)):
            _same(a.__getitem__(i, epoch), b.__getitem__(i, epoch))


def test_utils_copies_match(tmp_path):
    """utils/flops.py's MAC counts and utils/memory.py's caches and host
    readings against the JAX package's copies; device_trace writes a
    trace on the CPU (its peaks are the H100's, not the JAX package's)."""
    from video_chapter_generation_tpu.utils import flops as jax_flops
    from video_chapter_generation_tpu.utils import memory as jax_memory
    from video_chapter_generation_tpu_torch.utils import flops, memory
    from video_chapter_generation_tpu_torch.utils import profiling

    assert flops.resnet_macs_per_frame() == \
        jax_flops.resnet_macs_per_frame() == 4087136256
    assert flops.resnet_macs_per_frame(160, stage_sizes=(1, 2, 1, 1)) == \
        jax_flops.resnet_macs_per_frame(160, stage_sizes=(1, 2, 1, 1))
    assert flops.bert_encode_macs(100) == jax_flops.bert_encode_macs(100)
    args = (512, 30, 16, 16, 1024, 4096, 96103)
    assert flops.seq2seq_macs(*args) == jax_flops.seq2seq_macs(*args)
    assert (flops.PEAK_BF16, flops.PEAK_INT8) == (989e12, 1979e12)
    for mod in (memory, jax_memory):
        cm = mod.CacheManager()
        cm.cache("a", max_items=2)
        for k in range(3):
            cm.get("a", k, lambda k=k: k * k)
        assert cm.get("a", 2, lambda: -1) == 4 and cm.sizes() == {"a": 2}
        cm.purge()
        assert cm.sizes() == {"a": 0}
    assert memory.host_memory_mb().keys() == jax_memory.host_memory_mb().keys()
    mm = memory.MemoryManager()
    mm.handle_oom()
    assert mm.status()["oom_events"] == 1
    with profiling.device_trace(str(tmp_path)):
        with profiling.annotate("region"):
            np.ones(3).sum()
    assert list(tmp_path.glob("*.json"))


def test_frame_pack_and_host_seed_match(disk, tmp_path):
    """data/frames.py's VideoFramePack (the memmap file and the clips it
    serves, built and then reopened) and core/seeding.py's set_host_seed
    against the JAX package's copies."""
    import random

    from video_chapter_generation_tpu.core import seeding as jax_seeding
    from video_chapter_generation_tpu.data import frames as jax_frames
    from video_chapter_generation_tpu_torch.core import seeding
    from video_chapter_generation_tpu_torch.data import frames

    c, _ = _corpora(disk)
    vid = c.vids[0]
    paths = [c.frame_path(vid, i) for i in range(1, c.image_num(vid) + 2)]
    idx = [0, 1, 5, len(paths), len(paths) + 3]  # clipped at both ends
    packs = {}
    for name, mod in (("port", frames), ("jax", jax_frames)):
        pack = mod.VideoFramePack(str(tmp_path / name), vid, paths, hw=32)
        again = mod.VideoFramePack(str(tmp_path / name), vid, paths, hw=32)
        np.testing.assert_array_equal(pack.clip(idx), again.clip(idx))
        packs[name] = pack
    assert Path(packs["port"].path).read_bytes() == \
        Path(packs["jax"].path).read_bytes()
    _same(packs["port"].clip(idx), packs["jax"].clip(idx))
    draws = []
    for mod in (seeding, jax_seeding):
        mod.set_host_seed(7)
        draws.append((random.random(), np.random.rand(3).tolist()))
        mod.set_host_seed()
        draws.append((random.random(), np.random.rand(3).tolist()))
    assert draws[:2] == draws[2:]


@pytest.mark.parametrize("size", [(13, 21), (48, 70)])
def test_resize_frames_matches_jax_image_resize(size):
    """ops/preprocess.py:resize_frames (F.interpolate, bilinear,
    antialiased) against the JAX package's jax.image.resize "bilinear" at
    1e-5: a downscale and an upscale of [2, 3, 29, 37, 3] float32."""
    import jax.numpy as jnp
    import torch

    from video_chapter_generation_tpu.ops.preprocess import (
        resize_frames as jax_resize,
    )
    from video_chapter_generation_tpu_torch.ops.preprocess import (
        resize_frames,
    )

    x = np.random.default_rng(3).uniform(
        -2, 2, (2, 3, 29, 37, 3)).astype(np.float32)
    got = resize_frames(torch.from_numpy(x), *size).numpy()
    want = np.asarray(jax_resize(jnp.asarray(x), *size))
    assert got.shape == want.shape == (2, 3, *size, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
