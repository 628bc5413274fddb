"""CPU tests of the readers of the program's boundary-scoring spans
(vcgbench/metrics/, source program_span): each on a synthetic run
context, on the context of a program without the spans (nothing to
read), and a tiny traced run of the score cell that prints them.

    python -m pytest vcgbench/tests -q
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from vcgbench import harness  # noqa: E402

SPAN_METRICS = ("host_ms_per_clip.serve", "decode_ms_per_clip.serve",
                "copy_ms_per_clip.serve", "tokens_ms_per_clip.serve",
                "wait_share.serve", "h2d_ms_per_clip.serve")


def _stage(seconds, self_seconds=None, items=1):
    return {"seconds": seconds, "items": items,
            "items_per_sec": items / seconds,
            "self_seconds": seconds if self_seconds is None else self_seconds}


CTX = {"window_s": 50.0, "clips": 2000, "timer": {
    "host_load": _stage(30.0, 2.0, 2000), "decode": _stage(12.0, 12.0),
    "frames": _stage(20.0, 8.0), "collate": _stage(4.0),
    "tokens": _stage(3.0), "queue_wait": _stage(35.0),
    "h2d": _stage(2.4), "device_score": _stage(10.0, 10.0, 2000)}}


@pytest.mark.parametrize("name,want", [
    ("host_ms_per_clip.serve", 15.0),
    ("decode_ms_per_clip.serve", 6.0),
    ("copy_ms_per_clip.serve", 6.0),
    ("tokens_ms_per_clip.serve", 1.5),
    ("wait_share.serve", 70.0),
    ("h2d_ms_per_clip.serve", 1.2)])
def test_span_reader_on_a_synthetic_context(name, want):
    assert harness.read_metric(name, CTX) == pytest.approx(want)


def test_span_readers_find_nothing_without_the_spans():
    """The parent program's context: device_score and video_total, no
    self times."""
    old = {"window_s": 50.0, "clips": 2000, "timer": {
        k: {"seconds": 10.0, "items": 2000, "items_per_sec": 200.0}
        for k in ("device_score", "video_total")}}
    for name in SPAN_METRICS:
        assert harness.read_metric(name, old) is None, name
        assert harness.read_metric(name, {}) is None, name


def test_the_score_cell_reports_the_span_metrics():
    cell = harness.load_cell("score.window.w1")
    assert set(SPAN_METRICS) <= {m["name"] for m in cell.per_layer}


def test_tiny_traced_run_prints_the_span_metrics(tmp_path, monkeypatch):
    """At batches of 4, so that each tiny video takes several and
    score_clips runs its producer thread (one batch a video runs on the
    caller's thread alone, with no queue to wait on)."""
    import test_vcgbench_bench as bench

    tiny = bench.tiny_cell()
    tiny.config["serving"]["score_batch"] = 4
    monkeypatch.setattr(bench, "tiny_cell", lambda: tiny)
    rc, line, err = bench._tiny_run(tmp_path, monkeypatch, trace=True)
    assert rc == 0 and line["correct"] is True, err
    m = line["metrics"]
    for name in SPAN_METRICS:
        assert m[name]["value"] > 0, name
    assert m["wait_share.serve"]["value"] < 100
    parts = sum(m[k]["value"] for k in ("decode_ms_per_clip.serve",
                                        "copy_ms_per_clip.serve",
                                        "tokens_ms_per_clip.serve"))
    assert parts < m["host_ms_per_clip.serve"]["value"]
