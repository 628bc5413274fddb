"""The port's title data sets against the JAX package's, on the same
synthetic corpus, tokenizer and vision embeddings: ChapterTitleDataset,
AllChapterTitleDataset (ground-truth chapters and predicted cut points),
ChapterTitleVisionEmbDataset and AllChapterTitleVisionEmbDataset give
equal items for each seed and epoch, and the title decoder encoding
equals JAX's for a title longer than the decode length."""

import numpy as np
import pytest

from video_chapter_generation_tpu.data import corpus as jax_corpus
from video_chapter_generation_tpu.data import datasets as jax_datasets
from video_chapter_generation_tpu.data import text_encode as jax_text
from video_chapter_generation_tpu_torch.data import corpus, datasets
from video_chapter_generation_tpu_torch.data import text_encode
from video_chapter_generation_tpu_torch.data.synth import (
    make_synth_corpus_on_disk,
)
from video_chapter_generation_tpu_torch.data.tokenization import (
    UnigramTokenizer,
)

SEC = 64


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    root = tmp_path_factory.mktemp("title_data")
    paths = make_synth_corpus_on_disk(str(root), n_videos=4, video_sec=SEC,
                                      hw=32, splits={"train": 4})
    args = (paths["img_dir"], paths["data_file"], paths["train_vid_file"],
            paths["subtitle_dir"])
    ours, theirs = (corpus.VideoCorpus.from_files(*args),
                    jax_corpus.VideoCorpus.from_files(*args))
    tok = UnigramTokenizer.build_from_corpus(
        [s["text"] for vid in ours.vids for s in ours.subtitles(vid)],
        vocab_size=200)
    rng = np.random.default_rng(1)
    embs = {(vid, st): rng.standard_normal((4, 24)).astype(np.float32)
            for vid in ours.vids for st in range(0, SEC, 16)}

    def provider(vid, start, end):  # blocks meeting the chapter, at most 3
        return [embs[(vid, st)] for st in range(0, SEC, 16)
                if st < end and st + 16 > start][:3]

    return ours, theirs, tok, provider


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("seed", [0, 7])
def test_chapter_title_items_match(case, seed):
    ours, theirs, tok, provider = case
    kw = dict(max_text_len=48, chapter_title_text_len=6, seed=seed)
    pairs = [(datasets.ChapterTitleDataset(ours, tok, **kw),
              jax_datasets.ChapterTitleDataset(theirs, tok, **kw)),
             (datasets.ChapterTitleVisionEmbDataset(
                 ours, tok, provider, max_vision_emb=2, emb_dim=24, **kw),
              jax_datasets.ChapterTitleVisionEmbDataset(
                  theirs, tok, provider, max_vision_emb=2, emb_dim=24, **kw))]
    for a, b in pairs:
        assert len(a) == len(b) == 4
        for epoch in (0, 3):
            for i in range(len(a)):
                _same(a.__getitem__(i, epoch), b.__getitem__(i, epoch))
    item = pairs[1][0][0]
    assert item["vision_embs"].shape == (2, 24)
    assert item["vision_attention_mask"].sum() >= 1


@pytest.mark.parametrize("predicted", [False, True])
def test_all_chapter_title_items_match(case, predicted):
    ours, theirs, tok, provider = case
    cuts = ({vid: [0, 20, 41] for vid in ours.vids} if predicted else None)
    kw = dict(max_text_len=48, chapter_title_text_len=6, vid2cut_points=cuts)
    pairs = [(datasets.AllChapterTitleDataset(ours, tok, **kw),
              jax_datasets.AllChapterTitleDataset(theirs, tok, **kw)),
             (datasets.AllChapterTitleVisionEmbDataset(
                 ours, tok, provider, max_vision_emb=3, emb_dim=24, **kw),
              jax_datasets.AllChapterTitleVisionEmbDataset(
                  theirs, tok, provider, max_vision_emb=3, emb_dim=24,
                  **kw))]
    for a, b in pairs:
        assert len(a) == len(b) > len(ours.vids)
        assert a.items == b.items
        for i in range(len(a)):
            _same(a[i], b[i])


def test_title_decoder_encoding_matches(case):
    _, _, tok, _ = case
    for title, n in (("a short one", 8), ("a title far longer than the "
                                          "decoder length allows it", 5)):
        _same(text_encode.encode_title_decoder(title, tok, n),
              jax_text.encode_title_decoder(title, tok, n))
