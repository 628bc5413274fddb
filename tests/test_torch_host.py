"""The port's own copies of the JAX package's host-side modules against
the originals, on the same inputs (a synthetic corpus on disk): clip
grids, corpus records, training and inference dataset items, tokenizers,
collate and the loader, cut points, config overrides and the checkpoint
contract. All must be equal, not close: the copies are the same code."""

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
from video_chapter_generation_tpu_torch.core import config, contract
from video_chapter_generation_tpu_torch.data import (
    clip_grid,
    corpus,
    datasets,
    loader,
    synth,
    tokenization,
)
from video_chapter_generation_tpu_torch.evalkit import boundary


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
