"""The video pool of the chaptering cells: 1 fps JPEG frames on disk,
subtitles and chapter marks in memory, and the text vocabulary.

Every seed gets the same pool: the durations in the traffic file, the
same frames (written once per checkout under vcgbench/_cache/frames,
since their content does not depend on the seed) and the same number
of subtitle words a second. The seed draws the subtitle words, the
ground-truth chapter marks and the order in which the videos are
served, so every seed asks for the same work.

Frames are synthetic scenes: a low-frequency pattern that moves from
second to second, whose frequencies change at scene cuts, plus noise,
saved as JPEG at the traffic's quality (the entropy of a real frame, so
PIL's decode costs what it costs on real video). Subtitle words follow a
Zipf law over a fixed vocabulary of made-up words; the BERT vocabulary
holds every such word whole, so the tokenizer maps a word to one id.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from typing import List, Sequence

import numpy as np

LETTERS_C = "bcdfghjklmnprstvwz"
LETTERS_V = "aeiou"
BERT_SPECIALS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")


def words(n: int) -> List[str]:
    """n distinct made-up lowercase words (fixed: not drawn from a run's
    seed)."""
    rng = np.random.default_rng(20231)
    out, seen = [], set()
    while len(out) < n:
        k = int(rng.integers(2, 5))
        w = "".join(LETTERS_C[int(rng.integers(len(LETTERS_C)))]
                    + LETTERS_V[int(rng.integers(len(LETTERS_V)))]
                    for _ in range(k))
        if w not in seen:
            seen.add(w)
            out.append(w)
    return out


def bert_vocab(vocab_words: Sequence[str]) -> List[str]:
    return list(BERT_SPECIALS) + list(vocab_words)


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------


def _scene_cuts(v: int, duration: int) -> np.ndarray:
    rng = np.random.default_rng(1000 + v)
    cuts, t = [0], 0
    while True:
        t += int(rng.integers(40, 240))
        if t >= duration:
            return np.asarray(cuts)
        cuts.append(t)


def frame(v: int, t: int, cuts: np.ndarray, hw: int) -> np.ndarray:
    """uint8 [hw, hw, 3]: frame t (0-based second) of pool video v."""
    scene = int(np.searchsorted(cuts, t, side="right"))
    srng = np.random.default_rng((v * 7919 + scene) & 0x7FFFFFFF)
    fy = srng.integers(1, 6, 3).astype(np.float32)
    fx = srng.integers(1, 6, 3).astype(np.float32)
    off = srng.uniform(0, 2 * np.pi, 3).astype(np.float32)
    y = np.linspace(0, 2 * np.pi, hw, dtype=np.float32)[:, None, None]
    x = np.linspace(0, 2 * np.pi, hw, dtype=np.float32)[None, :, None]
    ph = np.float32(0.1 * t)
    base = np.sin(fy * y + off + ph) * np.cos(fx * x - ph)
    noise = np.random.default_rng((v * 100003 + t) & 0x7FFFFFFF).normal(
        0, 8.0, (hw, hw, 3)).astype(np.float32)
    return np.clip((base * 0.5 + 0.5) * 200.0 + 20.0 + noise, 0,
                   255).astype(np.uint8)


def _write_video(args) -> int:
    from PIL import Image

    root, v, duration, hw, quality = args
    d = Path(root) / f"pool{v}"
    d.mkdir(parents=True, exist_ok=True)
    cuts = _scene_cuts(v, duration)
    for t in range(duration):  # 1-based %05d.jpg, frame t + 1 is second t
        with open(d / ("%05d.jpg" % (t + 1)), "wb") as f:
            Image.fromarray(frame(v, t, cuts, hw)).save(f, format="JPEG",
                                                        quality=quality)
            f.flush()
            os.fsync(f.fileno())  # on disk before any window starts
    return duration


def frame_library(root: Path, durations: Sequence[int], hw: int,
                  quality: int, workers: int = 8) -> Path:
    """Write the pool's frames under root once (a manifest, written last,
    marks a complete library); returns root."""
    manifest = {"durations": list(map(int, durations)), "hw": hw,
                "quality": quality, "version": 1}
    man = root / "manifest.json"
    if man.exists() and json.loads(man.read_text()) == manifest:
        return root
    root.mkdir(parents=True, exist_ok=True)
    jobs = [(str(root), v, int(d), hw, quality)
            for v, d in enumerate(durations)]
    jobs.sort(key=lambda j: -j[2])
    import multiprocessing as mp

    with ProcessPoolExecutor(max_workers=max(1, min(workers, len(jobs))),
                             mp_context=mp.get_context("spawn")) as ex:
        list(ex.map(_write_video, jobs))
    man.write_text(json.dumps(manifest))
    return root


# ---------------------------------------------------------------------------
# the per-seed corpus
# ---------------------------------------------------------------------------


def subtitles(rng, duration: int, vocab_words: Sequence[str],
              words_per_s: float, every_s: int, zipf_a: float) -> List[dict]:
    """An entry every `every_s` seconds with Poisson(words_per_s * every_s)
    words (at least one), drawn by a Zipf law over vocab_words."""
    n = len(vocab_words)
    ranks = np.arange(1, n + 1, dtype=np.float64)
    p = ranks ** -zipf_a
    p /= p.sum()
    out = []
    for t in range(0, duration, every_s):
        k = max(1, int(rng.poisson(words_per_s * every_s)))
        idx = rng.choice(n, size=k, p=p)
        out.append({"text": " ".join(vocab_words[i] for i in idx),
                    "start": float(t)})
    return out


def pool(traffic: dict, seed: int) -> List[dict]:
    """The seed's videos: [{vid, v, duration, subtitles, cut_secs}], in the
    seed's order (a permutation of the traffic's durations)."""
    durations = traffic["durations_s"]
    vocab_words = words(traffic["vocab_words"])
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32, 11])
    order = rng.permutation(len(durations))
    vids = []
    for v in order:
        d = int(durations[v])
        n_ch = max(1, int(round(traffic["chapters_per_video"] * d
                                / np.mean(durations))))
        marks = sorted(int(s) for s in rng.choice(
            np.arange(10, d - 10), size=n_ch - 1, replace=False))
        vids.append({
            "vid": f"pool{v}", "v": int(v), "duration": d,
            "cut_secs": [0] + marks,
            "subtitles": subtitles(rng, d, vocab_words,
                                   traffic["words_per_s"],
                                   traffic["subtitle_every_s"],
                                   traffic["zipf_a"])})
    return vids


def corpus(videos: Sequence[dict], frames_root: Path):
    """The program's VideoCorpus over the pool (subtitles and frame
    counts in memory; frames from the library, whose directories carry
    the vids)."""
    from video_chapter_generation_tpu_torch.data.corpus import (
        VideoCorpus,
        VideoRecord,
    )

    records = {}
    for v in videos:
        lines = [f"{s // 60}:{s % 60:02d} chapter {i}"
                 for i, s in enumerate(v["cut_secs"])]
        records[v["vid"]] = VideoRecord(
            vid=v["vid"], title=v["vid"], duration=float(v["duration"]),
            timestamp_lines=lines, subtitles=list(v["subtitles"]),
            image_num=int(v["duration"]))
    c = VideoCorpus(records, [v["vid"] for v in videos], str(frames_root))
    return c
