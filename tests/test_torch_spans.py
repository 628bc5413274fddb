"""core/metrics.py's StepTimer spans, and the spans of boundary scoring
(pipeline/boundary.py score_clips, its producer thread, the window
score function and model, InferWindowClipDataset, FrameCache, collate)
on a tiny window model on the CPU."""

from __future__ import annotations

import contextlib
import sys
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from video_chapter_generation_tpu_torch.core.metrics import (
    StepTimer,
    current_timer,
    span,
)
from video_chapter_generation_tpu_torch.data.clip_grid import ClipInfo
from video_chapter_generation_tpu_torch.data.datasets import (
    InferWindowClipDataset,
)
from video_chapter_generation_tpu_torch.data.tokenization import (
    WordPieceTokenizer,
)
from video_chapter_generation_tpu_torch.models.bert import (
    BertConfig,
    BertModel,
)
from video_chapter_generation_tpu_torch.models.fusion import TwoStreamWindow
from video_chapter_generation_tpu_torch.models.resnet import ResNet
from video_chapter_generation_tpu_torch.pipeline.boundary import (
    make_window_score_fn,
    score_clips,
)

T, HW, N_CLIPS, BATCH = 4, 32, 10, 4
PRODUCER = ("host_load", "tokens", "frames", "decode", "collate")
CONSUMER = ("queue_wait", "h2d", "device_score")


def _threads_by_stage(t):
    """Note, per stage, the threads that close the timer's spans."""
    seen = {}
    stop = t.stop

    def spy(stage, items=1):
        seen.setdefault(stage, set()).add(threading.get_ident())
        return stop(stage, items)

    t.stop = spy
    return seen


def test_spans_nest_with_parent_and_self_time():
    t = StepTimer()
    with t.span("batch", 4):
        time.sleep(0.01)
        with t.span("item"):
            time.sleep(0.02)
        with t.span("item"):
            with t.span("leaf", 3):
                time.sleep(0.01)
    s = t.summary()
    assert s["item"]["items"] == 2 and s["batch"]["items"] == 4
    assert s["leaf"]["items"] == 3
    assert s["leaf"]["self_seconds"] == s["leaf"]["seconds"]
    assert s["item"]["self_seconds"] == pytest.approx(
        s["item"]["seconds"] - s["leaf"]["seconds"])
    assert s["batch"]["self_seconds"] == pytest.approx(
        s["batch"]["seconds"] - s["item"]["seconds"])
    assert 0.008 < s["batch"]["self_seconds"] < s["item"]["seconds"]
    assert s["leaf"]["seconds"] < s["item"]["seconds"] < \
        s["batch"]["seconds"]


def test_threads_time_one_stage_at_once():
    t = StepTimer()
    both_open = threading.Barrier(2, timeout=10)

    def worker():
        with t.span("load", 3):
            both_open.wait()
            time.sleep(0.02)

    threads = [threading.Thread(target=worker) for _ in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=10)
    assert not any(th.is_alive() for th in threads)
    assert t.counts["load"] == 6 and t.totals["load"] >= 0.04

    # more threads than cores, switching often: no count is lost
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def many():
            for _ in range(300):
                with t.span("tick"):
                    with t.span("tock", 2):
                        pass

        threads = [threading.Thread(target=many) for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
    finally:
        sys.setswitchinterval(switch)
    assert not any(th.is_alive() for th in threads)
    assert t.counts["tick"] == 16 * 300 and t.counts["tock"] == 2 * 16 * 300
    assert t.self_totals["tick"] <= t.totals["tick"]


def test_start_and_stop_as_before():
    t = StepTimer()
    t.start("step")
    time.sleep(0.005)
    dt = t.stop("step", 8)
    assert dt >= 0.005 and t.totals["step"] == dt and t.counts["step"] == 8
    assert t.rate("step") == pytest.approx(8 / dt)
    assert t.rate("never") == 0.0
    assert t.summary()["step"] == {"seconds": dt, "items": 8,
                                   "items_per_sec": 8 / dt,
                                   "self_seconds": dt}
    with pytest.raises(KeyError):
        t.stop("step")
    t.start("outer")
    t.start("inner")
    t.stop("outer")  # closed out of order: inner stays open
    assert t.stop("inner") > 0 and set(t.totals) == {"step", "outer",
                                                      "inner"}


def test_module_span_records_on_the_thread_bound_timer():
    with span("nowhere"):  # no timer bound: records nothing
        pass
    assert current_timer() is None
    outer, inner = StepTimer(), StepTimer()
    other = {}

    def elsewhere():
        other["timer"] = current_timer()
        with span("x"):
            pass

    with outer.bind():
        with span("a", 2):
            with inner.bind():
                with span("b"):
                    pass
                th = threading.Thread(target=elsewhere)
                th.start()
                th.join(timeout=10)
            assert current_timer() is outer
    assert current_timer() is None and other["timer"] is None
    assert dict(outer.counts) == {"a": 2} and dict(inner.counts) == {"b": 1}


def test_span_closes_when_its_block_raises():
    t = StepTimer()
    with pytest.raises(ValueError):
        with t.span("outer"):
            with t.span("inner", 5):
                raise ValueError("boom")
    assert t.counts["inner"] == 5 and t.counts["outer"] == 1
    assert t._stack() == []
    s = t.summary()
    assert s["outer"]["self_seconds"] == pytest.approx(
        s["outer"]["seconds"] - s["inner"]["seconds"])


# ---------------------------------------------------------------------------
# boundary scoring on a tiny window model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """One video of 2 * N_CLIPS + T frames on disk, N_CLIPS clips of T
    frames at stride 2, and a tokenizer for their texts."""
    root = tmp_path_factory.mktemp("span_frames")
    rng = np.random.default_rng(0)
    paths = []
    for i in range(2 * N_CLIPS + T):
        p = root / f"{i:05d}.jpg"
        Image.fromarray(rng.integers(0, 255, (HW, HW, 3), np.uint8)).save(p)
        paths.append(str(p))
    infos = [ClipInfo(paths[2 * k:2 * k + T], f"clip {k} says word{k % 3}",
                      int(k == 4), (2 * k, 2 * k + T), [8], "v0")
             for k in range(N_CLIPS)]
    tok = WordPieceTokenizer.build_from_corpus([c.text_clip for c in infos],
                                               vocab_size=64)
    return infos, tok


@pytest.fixture(scope="module")
def score_fn():
    model = TwoStreamWindow(BertModel(BertConfig.tiny()),
                            ResNet(50, n_segment=T, stage_sizes=(1, 1, 1, 1)),
                            segment_size=T, hidden_size=16).eval()
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if v.is_floating_point():
                v.copy_(0.1 * torch.randn(v.shape, generator=gen))
                if k.endswith("var"):
                    v.abs_().add_(1.0)
    return make_window_score_fn(model, torch.device("cpu"))


def _dataset(clips):
    infos, tok = clips
    return InferWindowClipDataset(infos, tok, T, 12, window_size=1, hw=HW)


def test_score_clips_records_each_stage_on_its_thread(clips, score_fn):
    ds = _dataset(clips)
    t = StepTimer()
    threads = _threads_by_stage(t)
    score_clips(ds, score_fn, BATCH, t, prefetch=2)
    s = t.summary()
    me = threading.get_ident()
    producer = threads["host_load"]
    assert len(producer) == 1 and me not in producer
    for stage in PRODUCER:
        assert threads[stage] == producer, stage
    for stage in CONSUMER:
        assert threads[stage] == {me}, stage
    assert set(threads) == set(PRODUCER + CONSUMER)
    batches = -(-N_CLIPS // BATCH)
    assert s["host_load"]["items"] == s["device_score"]["items"] == N_CLIPS
    assert s["h2d"]["items"] == s["collate"]["items"] == batches * BATCH
    assert s["queue_wait"]["items"] == batches + 1  # the last get: the end
    assert s["decode"]["items"] == ds.cache.misses == 2 * N_CLIPS + T - 2
    assert s["tokens"]["items"] == s["frames"]["items"] // T
    # parents by self time: each stage's children are its spans' only gaps
    children = sum(s[k]["seconds"] for k in ("frames", "tokens", "collate"))
    assert s["host_load"]["seconds"] - s["host_load"]["self_seconds"] == \
        pytest.approx(children, rel=1e-6)
    assert s["frames"]["seconds"] - s["frames"]["self_seconds"] == \
        pytest.approx(s["decode"]["seconds"], rel=1e-6)
    assert s["device_score"]["seconds"] - \
        s["device_score"]["self_seconds"] == \
        pytest.approx(s["h2d"]["seconds"], rel=1e-6)
    for stage in ("decode", "tokens", "collate", "h2d", "queue_wait"):
        assert s[stage]["self_seconds"] == s[stage]["seconds"], stage


def test_prefetch_off_records_host_load_on_the_callers_thread(clips,
                                                              score_fn):
    t = StepTimer()
    threads = _threads_by_stage(t)
    score_clips(_dataset(clips), score_fn, BATCH, t, prefetch=0)
    assert threads["host_load"] == threads["decode"] == \
        {threading.get_ident()}
    assert "queue_wait" not in threads and t.counts["host_load"] == N_CLIPS


@pytest.mark.parametrize("timer", ["own", "under_another", "absent"])
def test_scores_and_items_do_not_depend_on_the_timer(clips, score_fn, timer):
    """The timer given to score_clips, given while the caller has another
    bound (which it binds again afterwards), or none."""
    plain = _dataset(clips)
    want_items = [plain[i] for i in range(N_CLIPS)]
    want = [c.pred_score for c in score_clips(plain, score_fn, BATCH)]
    for c in plain.all_clip_infos:
        c.pred_score = c.pred_label = None
    t = None if timer == "absent" else StepTimer()
    outer = StepTimer()
    ds = _dataset(clips)
    with outer.bind() if timer == "under_another" else \
            contextlib.nullcontext():
        with t.bind() if t is not None else contextlib.nullcontext():
            items = [ds[i] for i in range(N_CLIPS)]
        tokens = t.counts["tokens"] if t is not None else 0
        got = [c.pred_score for c in score_clips(_dataset(clips), score_fn,
                                                 BATCH, t)]
        assert current_timer() is (outer if timer == "under_another"
                                   else None)
    for a, b in zip(items, want_items):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert got == want
    if t is not None:
        assert t.counts["device_score"] == N_CLIPS
        assert 0 < tokens and t.counts["tokens"] == 2 * tokens
    assert dict(outer.counts) == {}
