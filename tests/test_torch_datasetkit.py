"""The port's datasetkit/ copies (acquire, filtering, merge, sampler,
split, stats, topics and parsing) against the JAX package's originals on
the same seeded inputs: results equal, not close (the copies are the same
code), and the files they write equal byte for byte (the merge CSV, the
split files, the sampler JSON, resized JPEGs). HTTP and YouTube calls go
through injected fakes; nothing reaches the network. The scrape is
chip_smoke.py's synth_scrape at a small size (its datasetkit phase runs
the same chain at 2,000 videos). The last tests show the faults of the
JAX copies that the port corrects, each with both behaviours."""

import importlib.util
import json
import shutil
import sys
import types
from pathlib import Path

import numpy as np
import pytest

from video_chapter_generation_tpu import datasetkit as jax_datasetkit
from video_chapter_generation_tpu.data import corpus as jax_corpus
from video_chapter_generation_tpu.datasetkit import acquire as jax_acquire
from video_chapter_generation_tpu.datasetkit import filtering as jax_filtering
from video_chapter_generation_tpu.datasetkit import merge as jax_merge
from video_chapter_generation_tpu.datasetkit import parsing as jax_parsing
from video_chapter_generation_tpu.datasetkit import sampler as jax_sampler
from video_chapter_generation_tpu.datasetkit import split as jax_split
from video_chapter_generation_tpu.datasetkit import stats as jax_stats
from video_chapter_generation_tpu.datasetkit import topics as jax_topics
from video_chapter_generation_tpu_torch import datasetkit
from video_chapter_generation_tpu_torch.data import corpus, synth
from video_chapter_generation_tpu_torch.datasetkit import (
    acquire,
    filtering,
    merge,
    parsing,
    sampler,
    split,
    stats,
    topics,
)

ROOT = Path(__file__).resolve().parents[1]
WIKIHOW_HTML = """
<html><body><div class="content">
  <div class="responsive_thumb_title otherclass"><p>How to
     Draw a   Cat</p></div>
  <div class="responsive_thumb_title">How to Bake <b>Bread</b></div>
  <div class="unrelated">not a title</div>
</div></body></html>
"""


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _descriptions(seed=0, n=40):
    """Seeded video descriptions: chapter blocks (starting at 0:00 or
    not), stray timestamps, long lines, urls, h:mm:ss stamps."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lines = ["Welcome to the channel!"]
        start = 0 if rng.random() < 0.7 else int(rng.integers(5, 50))
        t = start
        for k in range(int(rng.integers(0, 7))):
            stamp = (f"{t // 3600}:{t // 60 % 60:02d}:{t % 60:02d}"
                     if rng.random() < 0.2 else f"{t // 60}:{t % 60:02d}")
            tail = " https://x.example/a" if rng.random() < 0.2 else ""
            lines.append(f"{stamp} - part {k}{tail}")
            t += int(rng.integers(20, 400))
        if rng.random() < 0.3:
            lines.append("x" * 160 + " 1:23")
        if rng.random() < 0.3:
            m, sec = int(rng.integers(1, 9)), int(rng.integers(10, 59))
            lines.append(f"see {m}:{sec} for the recap")
        out.append("\n".join(lines))
    return out


@pytest.fixture(scope="module")
def scrape(tmp_path_factory):
    """A small synthetic scrape (3 query directories of 30 videos)."""
    root = tmp_path_factory.mktemp("scrape")
    info = _chip_smoke().synth_scrape(root, seed=7, n_categories=3,
                                      n_rows=90)
    info["root"] = root
    info["asr_files"] = sorted(str(p) for p in root.glob("*/subtitle_*.json"))
    return info


@pytest.fixture(scope="module")
def disk(tmp_path_factory):
    """A synthetic corpus on disk (frames, CSV, subtitles), read by both
    copies of data/corpus.py."""
    paths = synth.make_synth_corpus_on_disk(
        str(tmp_path_factory.mktemp("corpus")), n_videos=4, video_sec=60,
        hw=32, splits={"train": 4})
    args = (paths["img_dir"], paths["data_file"], paths["vid_file"],
            paths["subtitle_dir"])
    return (corpus.VideoCorpus.from_files(*args),
            jax_corpus.VideoCorpus.from_files(*args))


def test_parsing_and_package_exports_match():
    assert datasetkit.__all__ == jax_datasetkit.__all__
    for name in datasetkit.__all__:
        assert getattr(datasetkit, name) is getattr(parsing, name)
    lines = [line for d in _descriptions(1) for line in d.split("\n")]
    assert parsing.parse_timestamp_lines(lines) == \
        jax_parsing.parse_timestamp_lines(lines)


def test_acquire_parsers_match():
    for d in _descriptions(2):
        for name in ("parse_description_timestamps",
                     "parse_timestamp_block", "is_chapter_video"):
            assert getattr(acquire, name)(d) == \
                getattr(jax_acquire, name)(d), name
        lines = acquire.parse_description_timestamps(d)
        assert acquire.timestamps_to_csv_cell(lines) == \
            jax_acquire.timestamps_to_csv_cell(lines)


class _Canned:
    def __init__(self, payload, status_code=200, text=""):
        self._payload, self.status_code, self.text = payload, status_code, text

    def json(self):
        return self._payload


def _youtube_fakes():
    """A fake Data API (two search pages, a description a video, one
    video gone: 404) and a fake ASR fetch (one video without captions)."""
    descs = dict(zip([f"vid{i}" for i in range(6)], _descriptions(3, 6)))
    descs["vid1"] = "0:00 intro\n1:00 more\n2:00 end"

    def item(vid):
        return {"id": {"kind": "youtube#video", "videoId": vid},
                "snippet": {"title": f"t-{vid}", "description": "short",
                            "publishedAt": "2021", "channelId": "c"}}

    pages = {None: {"items": [item(f"vid{i}") for i in range(4)]
                    + [{"id": {"kind": "youtube#channel"}}],
                    "nextPageToken": "p2"},
             "p2": {"items": [item("vid4"), item("vid5")]}}

    def http_get(url, params):
        if url == acquire.YOUTUBE_SEARCH_URL:
            return _Canned(pages[params.get("pageToken")])
        if params["id"] == "vid5":
            return _Canned(None, status_code=404)
        return _Canned({"items": [{"snippet": {
            "description": descs[params["id"]]}}]})

    def asr_fetch(vid):
        if vid == "vid3":
            raise RuntimeError("subtitles disabled")
        return [{"text": f"sub-{vid}", "start": 0.0}]

    return http_get, asr_fetch


def test_search_youtube_video_matches():
    http_get, asr_fetch = _youtube_fakes()
    got = acquire.search_youtube_video("how to paint", 6, "KEY", http_get,
                                       asr_fetch, n_workers=3)
    want = jax_acquire.search_youtube_video("how to paint", 6, "KEY",
                                            http_get, asr_fetch, n_workers=3)
    assert got == want and got["videoId"]
    vids = [f"vid{i}" for i in range(6)]
    assert acquire.fetch_descriptions(vids, "K", http_get, 2) == \
        jax_acquire.fetch_descriptions(vids, "K", http_get, 2)
    assert acquire.fetch_asr_many(vids, 2, asr_fetch) == \
        jax_acquire.fetch_asr_many(vids, 2, asr_fetch)
    quota = lambda url, params: _Canned({}, 403, "quota")  # noqa: E731
    for mod in (acquire, jax_acquire):
        with pytest.raises(RuntimeError, match="quota"):
            mod.search_youtube_video("q", 1, "K", quota)
        assert mod.search_youtube_video(
            "q", 1, "K", lambda u, p: _Canned({}, 500)) is None


def _raised(fn, *args):
    with pytest.raises(RuntimeError) as info:
        fn(*args)
    return str(info.value)


def test_gated_stages_raise_the_same(monkeypatch, tmp_path):
    """With each dependency missing, each stage raises the same error in
    both copies (the modules are hidden, ffmpeg taken off the path)."""
    for name in ("requests", "youtube_transcript_api", "yt_dlp", "cv2"):
        monkeypatch.setitem(sys.modules, name, None)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    vid = tmp_path / "v.mp4"
    calls = [
        ("_default_http_get", (acquire.YOUTUBE_VIDEO_URL, {}), "requests"),
        ("fetch_asr", ("vid",), "youtube_transcript_api"),
        ("download_video", ("vid", str(tmp_path)), "yt_dlp"),
        ("extract_frames", (str(vid), str(tmp_path / "f")), "ffmpeg"),
        ("extract_frames_many", ([str(vid)], str(tmp_path / "f")),
         "ffmpeg"),
    ]
    for name, args, dep in calls:
        msg = _raised(getattr(acquire, name), *args)
        assert msg == _raised(getattr(jax_acquire, name), *args)
        assert dep in msg
    msg = _raised(merge.video_duration, str(vid))
    assert msg == _raised(jax_merge.video_duration, str(vid)) and "cv2" in msg


def test_filtering_matches(disk, tmp_path):
    rng = np.random.default_rng(4)
    rows = []
    for i in range(60):
        secs = np.sort(rng.choice(600, int(rng.integers(0, 6)),
                                  replace=False))
        if rng.random() < 0.2:
            secs = secs[::-1]
        lines = [f"{s // 60}:{s % 60:02d} c{k}" for k, s in enumerate(secs)]
        if rng.random() < 0.1:
            lines.append("no stamp here")
        rows.append({"vid": f"v{i}", "duration": float(rng.uniform(60, 2400)),
                     "timestamp_lines": lines})
    for r in rows:
        for n in (1, 2, 3):
            assert filtering.has_valid_timestamps(r["timestamp_lines"], n) \
                == jax_filtering.has_valid_timestamps(r["timestamp_lines"], n)
    kw = dict(min_duration=120, max_duration=1500, blacklist=["v3", "v7"])
    assert filtering.filter_videos(rows, **kw) == \
        jax_filtering.filter_videos(rows, **kw)
    assert filtering.filter_videos(rows) == jax_filtering.filter_videos(rows)
    port_corpus, jax_corpus_ = disk
    for n in (16, 61):
        assert filtering.find_bad_vids(port_corpus, n) == \
            jax_filtering.find_bad_vids(jax_corpus_, n)
    path = tmp_path / "invalid_vids.txt"
    path.write_text("a\n\n  b \nc")
    assert filtering.load_invalid_vids(str(path)) == \
        jax_filtering.load_invalid_vids(str(path)) == ["a", "b", "c"]


def _write_mp4(path, seconds, fps=5):
    import cv2

    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"),
                             fps, (32, 32))
    for i in range(seconds * fps):
        writer.write(np.full((32, 32, 3), 8 * i % 256, np.uint8))
    writer.release()


def test_merge_matches(scrape, tmp_path, capsys):
    pytest.importorskip("cv2")
    asr = scrape["asr_files"]
    assert merge.load_dataset_with_subtitle(asr) == \
        jax_merge.load_dataset_with_subtitle(asr)
    vids, _, stamps, subs = merge.load_dataset_with_subtitle(asr)
    durations = scrape["durations"]
    for vid, stamp, sub in zip(vids, stamps, subs):
        assert merge.keep_video(durations[vid], sub, stamp) == \
            jax_merge.keep_video(durations[vid], sub, stamp)
    fake = [str(tmp_path / "videos" / f"{v}.mp4") for v in durations]
    fn = lambda p: durations[Path(p).stem]  # noqa: E731
    d = merge.collect_video_durations(fake, 3, fn)
    assert d == jax_merge.collect_video_durations(fake, 3, fn) == durations
    out = {}
    for name, mod in (("port", merge), ("jax", jax_merge)):
        out[name] = tmp_path / name / "all_in_one.csv"
        n = mod.combine_all_data_with_subtitle(asr, d, str(out[name]))
    assert 0 < n < len(durations)
    assert out["port"].read_bytes() == out["jax"].read_bytes()

    # main over real video files: cv2 writes 2- and 3-second mp4s, and an
    # unreadable one that collect_video_durations skips
    vdir = tmp_path / "videos"
    vdir.mkdir()
    for i, vid in enumerate(vids[:6]):
        _write_mp4(vdir / f"{vid}.mp4", 2 + i % 2)
    (vdir / f"{vids[6]}.mp4").write_bytes(b"not a video")
    path = str(vdir / f"{vids[0]}.mp4")
    assert merge.video_duration(path) == jax_merge.video_duration(path) == 2.0
    for name, mod in (("port", merge), ("jax", jax_merge)):
        out[name] = tmp_path / f"main_{name}.csv"
        mod.main(["--dataset_dir", str(scrape["root"]), "--video_dir",
                  str(vdir), "--out", str(out[name]), "--workers", "2"])
    said = capsys.readouterr().out.splitlines()
    assert said[0].replace("main_port", "main_jax") == said[1]
    assert out["port"].read_bytes() == out["jax"].read_bytes()


def _vid2row(scrape):
    vids, _, stamps, _ = merge.load_dataset_with_subtitle(scrape["asr_files"])
    return {v: {"vid": v, "duration": scrape["durations"][v],
                "timestamp_lines": s} for v, s in zip(vids, stamps)}


def test_sampler_matches(scrape, tmp_path):
    vid2row = _vid2row(scrape)
    q2c = {q: f"Category:{i % 2}" for i, q in enumerate(scrape["queries"])}
    cat2vid = topics.categorize_vids(scrape["asr_files"], q2c)
    cat2vid["Category:Youth"] = cat2vid["Category:1"][:5]
    targets = {c: dict(sampler.stats_for_videos(vs, vid2row),
                       video_count=len(vs) // 2)
               for c, vs in cat2vid.items()}
    targets["Category:0"]["avg_words_per_chapter"] *= 3  # never met
    targets["Category:too_few"] = dict(targets["Category:1"],
                                       video_count=10 ** 6)
    cat2vid["Category:too_few"] = []
    for c, vs in cat2vid.items():
        if vs:
            assert sampler.stats_for_videos(vs, vid2row) == \
                jax_sampler.stats_for_videos(vs, vid2row)
    for band in (0.01, 0.05, 0.5):
        assert sampler.stats_in_range(targets["Category:0"],
                                      targets["Category:1"], band) == \
            jax_sampler.stats_in_range(targets["Category:0"],
                                       targets["Category:1"], band)
    files = {}
    for name, mod in (("port", sampler), ("jax", jax_sampler)):
        s = mod.DatasetSampler(cat2vid, targets, vid2row, max_attempts=20,
                               seed=11)
        assert s.sample_all_categories() == 2  # Category:1 and Youth
        files[name] = (tmp_path / f"{name}_v.json",
                       tmp_path / f"{name}_s.json")
        s.save_results(*map(str, files[name]))
    for a, b in zip(files["port"], files["jax"]):
        assert a.read_bytes() == b.read_bytes()
    assert set(json.loads(files["port"][0].read_text())) == {
        "Category:1", "Category:Youth"}


def test_split_matches(scrape, disk, tmp_path, capsys):
    csv = tmp_path / "all_in_one.csv"
    merge.combine_all_data_with_subtitle(
        scrape["asr_files"], scrape["durations"], str(csv))
    vids = parsing.parse_csv_to_list(str(csv))[0]
    assert split.split_vids(vids) == jax_split.split_vids(vids)
    assert split.split_vids(vids, 5, (0.5, 0.3, 0.2)) == \
        jax_split.split_vids(vids, 5, (0.5, 0.3, 0.2))
    for name, mod in (("port", split), ("jax", jax_split)):
        mod.main(["--data_file", str(csv), "--out_dir", str(tmp_path / name),
                  "--seed", "3"])
    said = capsys.readouterr().out.splitlines()
    assert [x.replace("/port/", "/jax/") for x in said[:3]] == said[3:]
    for part in ("train", "val", "test"):
        a = (tmp_path / "port" / f"{part}.txt").read_bytes()
        assert a and a == (tmp_path / "jax" / f"{part}.txt").read_bytes()
    # the human-label split, the intersections and the subsets
    labels = tmp_path / "labels.csv"
    rows = [f"{v},{i % 4 - 1},{'' if i % 3 else (i + 1) % 4 - 1}\n"
            for i, v in enumerate(vids)]
    labels.write_text("object id,1_label_result,2_label_result\n"
                      + "".join(rows))
    easy_hard = split.split_easy_hard_from_labels(str(labels))
    assert easy_hard == jax_split.split_easy_hard_from_labels(str(labels))
    assert split.intersect_split(vids[::2], *easy_hard[:2]) == \
        jax_split.intersect_split(vids[::2], *easy_hard[:2])
    for frac, seed in ((0.3, 42), (0.55, 1)):
        assert split.subset_split(vids, frac, seed) == \
            jax_split.subset_split(vids, frac, seed)
    clips = [{"vid": v, "clip": k} for v in vids for k in range(2)]
    assert split.filter_clips_to_vids(clips, vids[:5]) == \
        jax_split.filter_clips_to_vids(clips, vids[:5])
    port_corpus, jax_corpus_ = disk
    for threshold in (0.0, 0.25, 0.9):
        assert split.rouge_upper_bound_split(port_corpus, threshold) == \
            jax_split.rouge_upper_bound_split(jax_corpus_, threshold)


def test_stats_match(scrape, disk):
    rows = list(_vid2row(scrape).values())
    rows.append({"vid": "x", "timestamp_lines": ["bad", "0:10 a"]})
    assert stats.video_stats(rows) == jax_stats.video_stats(rows)
    assert stats.video_stats([]) == jax_stats.video_stats([])
    for kw in ({}, {"clip_frame_num": 8, "max_offset": 1}):
        assert stats.clips_per_video(rows, **kw) == \
            jax_stats.clips_per_video(rows, **kw)
    assert stats.clips_per_video([]) == jax_stats.clips_per_video([])
    port_corpus, jax_corpus_ = disk
    for n in (1, 1000):
        assert stats.subtitle_vocab(port_corpus, n) == \
            jax_stats.subtitle_vocab(jax_corpus_, n)


def test_topics_match(scrape, tmp_path):
    pytest.importorskip("PIL")
    from PIL import Image

    assert topics.WIKIHOW_SUBJECTS == jax_topics.WIKIHOW_SUBJECTS
    assert topics.parse_wikihow_titles(WIKIHOW_HTML) == \
        jax_topics.parse_wikihow_titles(WIKIHOW_HTML)
    pages = dict(scrape["pages"])
    pages[topics.WIKIHOW_WEBSITE + "Category:Travel"] = WIKIHOW_HTML
    cat2q = topics.scrape_wikihow_queries(http_get=pages.get)
    assert cat2q == jax_topics.scrape_wikihow_queries(http_get=pages.get)
    queries = scrape["queries"] + ["How to Bake Bread", "How to Fly"]
    q2c, counts = topics.assign_query_categories(queries, cat2q)
    assert (q2c, counts) == jax_topics.assign_query_categories(queries, cat2q)
    asr = scrape["asr_files"]
    for p in asr[:5]:
        assert topics.subtitle_path_query(p) == \
            jax_topics.subtitle_path_query(p)
    valid = [topics.subtitle_path_query(p)[1] for p in asr[::3]]
    for v in (None, valid):
        assert topics.categorize_vids(asr, q2c, v) == \
            jax_topics.categorize_vids(asr, q2c, v)
    desc = "hi\n0:00 intro http://x.example/y\n1:30 middle\n3:45 end\n"

    def http_get(url, params):
        return {"items": [{"snippet": {"description": desc}}]} \
            if params["id"] == "abc" else {"items": []}

    for vid in ("abc", "gone"):
        assert topics.fetch_video_chapters(vid, "K", http_get) == \
            jax_topics.fetch_video_chapters(vid, "K", http_get)
    per_file = {"b.csv": ["x1", "x2"], "a.csv": [f"y{i}" for i in range(7)]}
    assert topics.annotation_urls(per_file) == \
        jax_topics.annotation_urls(per_file)
    assert topics.annotation_urls(per_file, 2) == \
        jax_topics.annotation_urls(per_file, 2)
    # resize_frames rewrites the JPEGs in place: the same bytes
    rng = np.random.default_rng(5)
    for name in ("port", "jax"):
        (tmp_path / name).mkdir()
    for i in range(3):
        img = Image.fromarray(rng.integers(0, 256, (40 + i, 50, 3),
                                           dtype=np.uint8))
        for name in ("port", "jax"):
            img.save(tmp_path / name / f"{i + 1:05d}.jpg")
    assert topics.resize_frames(str(tmp_path / "port"), 24) == \
        jax_topics.resize_frames(str(tmp_path / "jax"), 24) == 3
    for i in range(3):
        a = (tmp_path / "port" / f"{i + 1:05d}.jpg").read_bytes()
        assert a == (tmp_path / "jax" / f"{i + 1:05d}.jpg").read_bytes()
        assert Image.open(tmp_path / "port" / f"{i + 1:05d}.jpg").size == \
            (24, 24)


# --- faults of the JAX copies that the port corrects (ROADMAP Queue 3) ---

def test_keep_video_zero_duration():
    """A 0-second video: the JAX copy divides by its duration; the port
    drops it."""
    subs, lines = [{"text": "a b c"}], ["0:00 a", "0:01 b", "0:02 c"]
    with pytest.raises(ZeroDivisionError):
        jax_merge.keep_video(0.0, subs, lines)
    assert merge.keep_video(0.0, subs, lines) is False
    assert merge.keep_video(10.0, subs, lines) == \
        jax_merge.keep_video(10.0, subs, lines)


def test_split_writes_an_empty_split_empty(tmp_path):
    """One video: train and val are empty. The JAX copy writes "\\n"
    (read back line by line, one empty vid id); the port an empty file.
    The test split is the same bytes."""
    csv = tmp_path / "one.csv"
    csv.write_text(",videoId,title,duration,timestamp\n0,v1,t,60.0,0:00 a\n")
    for name, mod in (("port", split), ("jax", jax_split)):
        mod.main(["--data_file", str(csv), "--out_dir", str(tmp_path / name)])
    for part in ("train", "val"):
        assert (tmp_path / "jax" / f"{part}.txt").read_text() == "\n"
        assert (tmp_path / "jax" / f"{part}.txt").read_text().split(
            "\n")[:-1] == [""]
        assert (tmp_path / "port" / f"{part}.txt").read_text() == ""
    assert (tmp_path / "port" / "test.txt").read_bytes() == \
        (tmp_path / "jax" / "test.txt").read_bytes() == b"v1\n"


def test_categorize_vids_without_a_subtitle_file():
    """A valid vid without a subtitle file: the JAX copy raises KeyError;
    the port files it under "unknown"."""
    paths = ["d/How to Run/subtitle_vidA.json"]
    q2c = {"How to Run": "Category:Health"}
    with pytest.raises(KeyError):
        jax_topics.categorize_vids(paths, q2c, valid_vids=["vidA", "vidZ"])
    assert topics.categorize_vids(paths, q2c, valid_vids=["vidA", "vidZ"]) \
        == {"Category:Health": ["vidA"], "unknown": ["vidZ"]}


def test_fetch_video_chapters_default_getter(monkeypatch):
    """Without an injected http_get (here a stand-in `requests` module):
    the JAX copy calls .get on the response object and raises
    AttributeError; the port reads its JSON body."""
    body = {"items": [{"snippet": {"description": "0:00 a\n1:00 b"}}]}
    seen = []

    def get(url, params=None):
        seen.append((url, params))
        return _Canned(body)

    monkeypatch.setitem(sys.modules, "requests",
                        types.SimpleNamespace(get=get))
    with pytest.raises(AttributeError):
        jax_topics.fetch_video_chapters("abc", "K")
    assert topics.fetch_video_chapters("abc", "K") == ["0:00 a", "1:00 b"]
    assert seen[0] == seen[1] and seen[1][1]["id"] == "abc"
    monkeypatch.setitem(sys.modules, "requests", types.SimpleNamespace(
        get=lambda url, params=None: _Canned(None, status_code=404)))
    assert topics.fetch_video_chapters("abc", "K") == []
