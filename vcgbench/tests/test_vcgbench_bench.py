"""CPU tests of the benchmark harness (vcgbench/): its generator, its
arithmetic, its result line, what it imports, and a whole run of the
score cell at a tiny size past the harness's look for a card, clean and
with the program broken underneath. The control at the cell's own size
needs the card (marked cuda).

    python -m pytest vcgbench/tests -q
"""

from __future__ import annotations

import ast
import copy
import io
import json
import subprocess
import sys
import types
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from vcgbench import flops, harness  # noqa: E402
from vcgbench.gen import videos  # noqa: E402
from vcgbench.kinds import score  # noqa: E402


def tiny_cell(name: str = "score.window.w1") -> harness.Cell:
    """The cell with a program small enough for a CPU: BERT and the heads
    at width 32 and 16, one bottleneck a stage, 64 px frames, three
    videos of under a minute."""
    cell = harness.load_cell(name)
    c = copy.deepcopy(cell.config)
    c["bert"].update(vocab_size=64, hidden_size=32, num_layers=2,
                     num_heads=2, intermediate_size=64,
                     max_position_embeddings=128)
    c["vision"]["stage_sizes"] = [1, 1, 1, 1]
    c["head"]["hidden_size"] = 16
    c["serving"]["max_text_len"] = 16
    t = copy.deepcopy(cell.traffic)
    t.update(durations_s=[40, 60, 50], frame_hw=64, vocab_words=50,
             chapters_per_video=2, trace={"start_s": 0.5, "length_s": 1.0},
             work_rate_s_per_s=10, sample_clips=8)
    cell.config, cell.traffic = c, t
    return cell


# ---------------------------------------------------------------------------
# traffic
# ---------------------------------------------------------------------------


def test_video_pool_is_the_seeds_and_in_range():
    traffic = harness.load_cell("score.window.w1").traffic
    seed = 2 ** 31 + 12345
    a, b = videos.pool(traffic, seed), videos.pool(traffic, seed)
    assert json.dumps(a) == json.dumps(b)
    other = videos.pool(traffic, seed + 1)
    assert [v["vid"] for v in other] != [v["vid"] for v in a] or \
        json.dumps(other) != json.dumps(a)
    assert sorted(v["duration"] for v in a) == sorted(traffic["durations_s"])
    vocab = set(videos.words(traffic["vocab_words"]))
    total_words = total_s = 0
    for v in a:
        d = v["duration"]
        assert [s["start"] for s in v["subtitles"]] == list(
            map(float, range(0, d, traffic["subtitle_every_s"])))
        for s in v["subtitles"]:
            assert set(s["text"].split()) <= vocab
            total_words += len(s["text"].split())
        total_s += d
        assert v["cut_secs"][0] == 0
        assert all(10 <= c < d - 10 for c in v["cut_secs"][1:])
    assert abs(total_words / total_s - traffic["words_per_s"]) < 0.1


def test_work_is_whole_passes_the_same_for_every_seed():
    traffic = harness.load_cell("score.window.w1").traffic
    assert score.passes(traffic, 45.0) == 1
    assert score.passes(traffic, 1.0) == 1
    assert score.passes(traffic, 2 * sum(traffic["durations_s"])
                        / traffic["work_rate_s_per_s"]) == 2
    for seed in (1, 2 ** 33 + 1):
        assert sorted(v["duration"] for v in videos.pool(traffic, seed)) \
            == sorted(traffic["durations_s"])


def test_head_shift_gives_the_target_chapter_count():
    rng = np.random.default_rng(3)
    logits = np.stack([np.zeros(146), np.convolve(
        rng.normal(size=146), np.ones(5) / 5, "same")], axis=1)
    delta = score.shift_for(logits, 3.2)
    cuts = score.host.cut_points(
        (logits[:, 1] + delta - logits[:, 0] >= 0).astype(int).tolist())
    assert abs(len(cuts) - 3.2) <= 1


# ---------------------------------------------------------------------------
# arithmetic
# ---------------------------------------------------------------------------


def test_resnet50_macs_a_frame():
    assert abs(flops.resnet_macs_per_frame(224, (3, 4, 6, 3)) / 4.09e9
               - 1) < 0.005


def test_one_plain_block_bound_by_hand():
    # layer1's second block at a 256-frame call: 56 x 56, 256 -> 64 -> 256
    m = 256 * 56 * 56
    fl = 2 * m * (256 * 64 + 9 * 64 * 64 + 64 * 256)
    nbytes = m * 256 * 2 + (256 * 64 + 9 * 64 * 64 + 64 * 256) * 2 \
        + m * 256 * 2
    got = flops.block_work(256, 56, 56, 256, 64, 256, 1, False)
    assert got[0] == fl
    want = max(fl / 989e12, nbytes / 3.35e12)
    assert flops.bound(fl, nbytes)[0] == pytest.approx(want)
    assert flops.bound(fl, nbytes)[1] == "bytes"
    parts = flops.trunk_parts(256, 224, (3, 4, 6, 3), "s2d")
    assert parts[2] == (fl, nbytes)


# ---------------------------------------------------------------------------
# the result line
# ---------------------------------------------------------------------------


def test_result_line_shape(monkeypatch):
    import vcgbench.run as run

    cell = harness.load_cell("score.window.w1")
    monkeypatch.setattr(harness, "device_record", lambda n, p: {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": n,
        "memory_peak_bytes": p})
    out = {"attempted": 8, "failed": 0, "video_s_per_s": 250.0,
           "video_s_per_card_s": 1400.0, "setup_s": 30.0, "peak": 4 << 30,
           "ctx": {},
           "checks": [harness.check("score_gap", 0.01, 0.045),
                      harness.check("cut_mismatch", 0.0, 0)]}
    buf, err = io.StringIO(), io.StringIO()
    with redirect_stdout(buf), redirect_stderr(err):
        assert run.finish(cell, out, False) == 0
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True
    assert line["metrics"] == {"video_s_per_card_s": {"value": 1400.0,
                                                      "unit": "s/s"},
                               "setup_s": {"value": 30.0, "unit": "s"}}
    assert line["checks"]["score_gap"] == {"value": 0.01, "limit": 0.045}
    assert err.getvalue().strip().splitlines()[-1].startswith(
        "check cut_mismatch: 0.0 limit 0")
    out["checks"][0] = harness.check("score_gap", 0.05, 0.045)
    buf = io.StringIO()
    with redirect_stdout(buf), redirect_stderr(io.StringIO()):
        run.finish(cell, out, False)
    assert json.loads(buf.getvalue().strip().splitlines()[-1])[
        "correct"] is False


# ---------------------------------------------------------------------------
# what the harness and the reference import
# ---------------------------------------------------------------------------


def _imported_tops(path: Path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".", 1)[0])
    return tops


def test_no_source_imports_jax_or_the_jax_package():
    for path in (ROOT / "vcgbench").rglob("*.py"):
        bad = _imported_tops(path) & set(harness.FORBIDDEN)
        assert not bad, f"{path} imports {bad}"


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import vcgbench.reference.nets, vcgbench.reference.host\n"
            "import vcgbench.reference.chaptering\n"
            "print(sorted({m.split('.', 1)[0] for m in sys.modules}))"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    tops = set(json.loads(out.strip().replace("'", '"')))
    assert "video_chapter_generation_tpu_torch" not in tops
    assert not tops & set(harness.FORBIDDEN)
    for path in (ROOT / "vcgbench" / "reference").glob("*.py"):
        assert "video_chapter_generation_tpu_torch" not in \
            _imported_tops(path)


# ---------------------------------------------------------------------------
# a whole run at a tiny size, and the program broken underneath it
# ---------------------------------------------------------------------------


def _cpu_record(monkeypatch):
    monkeypatch.setattr(harness, "device_record", lambda n, p: {
        "platform": "cpu", "kind": "cpu", "count": n,
        "memory_peak_bytes": p})


def _tiny_run(tmp_path, monkeypatch, fault=None, trace=False):
    """(exit code, the result line or None, standard error) of a run of
    the tiny cell on the CPU, past the harness's look for a card."""
    import video_chapter_generation_tpu_torch.pipeline as pipeline

    import vcgbench.run as run

    if fault is not None:
        real = pipeline.make_window_score_fn

        def broken(model, dev, quant_scales=None):
            inner = real(model, dev, quant_scales)

            def fn(batch):
                return fault(inner(batch))

            return fn

        monkeypatch.setattr(pipeline, "make_window_score_fn", broken)
    _cpu_record(monkeypatch)
    buf, err = io.StringIO(), io.StringIO()
    with redirect_stdout(buf), redirect_stderr(err):
        rc = run.run_cell(tiny_cell(), 3 * 2 ** 31 + 5, 2.0, trace,
                          device_name="cpu", cache=tmp_path)
    lines = buf.getvalue().strip().splitlines()
    return rc, json.loads(lines[-1]) if lines else None, err.getvalue()


def test_tiny_run_is_correct_and_loads_no_jax(tmp_path, monkeypatch):
    rc, line, err = _tiny_run(tmp_path, monkeypatch, trace=True)
    assert rc == 0, err
    assert line["correct"] is True, err
    assert line["failed"] == 0 and line["attempted"] == 3
    assert set(line["checks"]) == {"score_gap", "cut_mismatch"}
    assert line["metrics"]["score_ms_per_clip.serve"]["value"] > 0
    assert line["metrics"]["video_s_per_s.flow"]["value"] > 0
    assert err.strip().splitlines()[-1].startswith("check cut_mismatch")
    assert harness.forbidden_modules() == []


def test_a_run_that_loaded_jax_prints_no_result(monkeypatch):
    import vcgbench.run as run

    canned = {"attempted": 1, "failed": 0, "video_s_per_s": 1.0,
              "video_s_per_card_s": 5.0, "setup_s": 1.0, "peak": 0, "ctx": {},
              "checks": [harness.check("score_gap", 0.0, 0.045)]}
    monkeypatch.setattr(score, "run", lambda *a, **k: canned)
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax"))
    _cpu_record(monkeypatch)
    buf, err = io.StringIO(), io.StringIO()
    with redirect_stdout(buf), redirect_stderr(err):
        rc = run.run_cell(harness.load_cell("score.window.w1"), 1, 1.0,
                          False, device_name="cpu")
    assert rc != 0 and buf.getvalue() == ""
    assert "jax" in err.getvalue()


def _half_batch(p):
    """Half of the batch left out: its rows take the mean of the rest."""
    import torch

    p = torch.as_tensor(p).clone()
    h = p.shape[0] // 2
    p[h:] = p[:h].mean()
    return p


def _altered(p):
    """An answer altered where it is produced: the first clip's score
    moved by half the range."""
    import torch

    p = torch.as_tensor(p).clone()
    p[0] = (p[0] + 0.5) % 1.0
    return p


@pytest.mark.parametrize("fault", [_half_batch, _altered],
                         ids=["half_batch_left_out", "answer_altered"])
def test_tiny_run_with_the_program_broken_is_not_correct(tmp_path,
                                                         monkeypatch, fault):
    rc, line, err = _tiny_run(tmp_path, monkeypatch, fault)
    assert rc == 0, err
    assert line["correct"] is False, err
    assert line["metrics"]["video_s_per_card_s"]["value"] > 0


# ---------------------------------------------------------------------------
# the control at the cell's own size (on the card)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_control_fails_the_score_limit_at_the_cells_size():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("the control runs the cell at its own size on a card")
    cell = harness.load_cell("score.window.w1")
    for seed in (1212121212, 3434343434, 5656565656):
        res = subprocess.run(
            [sys.executable, str(ROOT / "vcgbench" / "run.py"), "--workload",
             cell.name, "--seed", str(seed), "--seconds", "10", "--trace",
             "0", "--control", "1"], capture_output=True, text=True,
            cwd=ROOT, timeout=600)
        assert res.returncode == 0, res.stderr[-4000:]
        line = json.loads(res.stdout.strip().splitlines()[-1])
        assert line["correct"] is False
        assert line["checks"]["score_gap"]["value"] > \
            cell.limits["score_gap"]
