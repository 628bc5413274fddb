"""Synthetic ON-DISK corpus: real JPEG frames + subtitle JSONs + CSV.

The port's own copy of video_chapter_generation_tpu/data/synth.py (the definitions the port uses;
each names the line it was copied from), so the port never imports
the JAX package.
"""

from __future__ import annotations
import json
import os
from typing import Dict, List, Optional
import numpy as np
from ..datasetkit.parsing import TIMESTAMP_DELIMITER


_WORDS = (
    "intro setup overview board game rules strategy tips tricks final "
    "thoughts review unboxing gameplay score win lose turn card dice move "
    "first second third because therefore example question answer detail"
).split()


def synth_frame(vid_seed: int, t: int, hw: int = 224,
                style: int = 0) -> np.ndarray:
    """Deterministic uint8 [hw, hw, 3] frame: moving low-frequency pattern
    plus mild noise (realistic JPEG entropy, not pathological).

    style=0 keeps the original pattern (benchmark corpora, manifests
    unchanged); style>0 draws the pattern frequencies/phases from a
    style-keyed RNG — the learnable corpus gives each chapter its own
    style so the visual statistics JUMP at chapter boundaries and a
    vision model can genuinely learn them.

    Copied from video_chapter_generation_tpu/data/synth.py:32.
    """
    rng = np.random.default_rng((vid_seed * 100003 + t) & 0x7FFFFFFF)
    y = np.linspace(0, 2 * np.pi, hw, dtype=np.float32)[:, None]
    x = np.linspace(0, 2 * np.pi, hw, dtype=np.float32)[None, :]
    phase = 0.1 * t
    if style == 0:
        fy = (2.0, 1.0, 3.0)
        fx = (1.0, 2.0, 1.0)
        off = (0.0, 0.0, 0.0)
    else:
        srng = np.random.default_rng(style & 0x7FFFFFFF)
        fy = tuple(float(f) for f in srng.integers(1, 6, 3))
        fx = tuple(float(f) for f in srng.integers(1, 6, 3))
        off = tuple(float(o) for o in srng.uniform(0, 2 * np.pi, 3))
    base = np.stack([
        np.sin(fy[0] * y + phase + off[0]) * np.cos(fx[0] * x - phase),
        np.sin(fy[1] * y - 0.5 * phase + off[1]) * np.cos(fx[1] * x + phase),
        np.sin(fy[2] * y + fx[2] * x + 0.3 * phase + off[2]),
    ], axis=-1)
    img = (base * 0.5 + 0.5) * 200.0 + rng.normal(0, 8.0, (hw, hw, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _subtitles(rng, duration: int) -> List[Dict]:
    """Copied from video_chapter_generation_tpu/data/synth.py:64."""
    out = []
    for t in range(0, duration, 2):
        n = int(rng.integers(3, 8))
        words = [_WORDS[int(rng.integers(0, len(_WORDS)))] for _ in range(n)]
        out.append({"text": " ".join(words), "start": float(t)})
    return out


_MARKERS = "okay moving onto brandnew section".split()


def make_synth_corpus_on_disk(
    root: str,
    n_videos: int = 8,
    video_sec: int = 300,
    n_chapters: int = 7,
    hw: int = 224,
    seed: int = 0,
    quality: int = 80,
    split: str = "test",
    learnable: bool = False,
    splits: Optional[Dict[str, int]] = None,
) -> Dict[str, str]:
    """Write a complete synthetic corpus under `root` and return the paths
    dict {img_dir, data_file, vid_file, subtitle_dir}. Idempotent: an
    existing corpus with a matching manifest is reused (JPEG encode of
    n_videos*video_sec frames is the expensive part).

    learnable=True plants real signal at the chapter structure so models
    trained on the corpus reach non-trivial task metrics (the impl-A/B
    accuracy harness, tools/impl_ab_eval.py):
    - each chapter gets its own frame style (synth_frame style arg) —
      the visual statistics jump at every boundary;
    - marker words + the chapter's keywords are injected into the
      subtitles at the cut seconds (clip text windows straddling a cut
      contain them; others don't);
    - chapter titles are their keywords, which also pepper the chapter's
      regular subtitles — titles become extractable from the text.

    splits={"train": 12, "val": 2, "test": 4} partitions the vids into
    per-split files (paths gain '<name>_vid_file' keys); default keeps
    the single `split` file.


    Copied from video_chapter_generation_tpu/data/synth.py:79.
    """
    from PIL import Image

    manifest = {
        "n_videos": n_videos, "video_sec": video_sec, "hw": hw,
        "seed": seed, "quality": quality, "n_chapters": n_chapters,
        "learnable": learnable, "splits": splits,
        # bump to invalidate corpora built by older generator versions
        "synth_version": 2,
    }
    man_path = os.path.join(root, "manifest.json")
    img_dir = os.path.join(root, "frames")
    data_file = os.path.join(root, "dataset", "all_in_one_with_subtitle.csv")
    if splits:
        assert sum(splits.values()) == n_videos, (splits, n_videos)
        split_names = list(splits)
    else:
        split_names = [split]
    vid_files = {
        name: os.path.join(root, "dataset", f"{name}.txt")
        for name in split_names
    }
    paths = {
        "img_dir": img_dir,
        "data_file": data_file,
        "vid_file": vid_files[split_names[0]],
        "subtitle_dir": os.path.join(root, "dataset"),
    }
    for name, pth in vid_files.items():
        paths[f"{name}_vid_file"] = pth
    if os.path.exists(man_path):
        with open(man_path) as f:
            if json.load(f) == manifest and all(
                    os.path.exists(p) for p in vid_files.values()):
                return paths

    os.makedirs(os.path.join(root, "dataset", "synth query"), exist_ok=True)
    rows = []
    vids = []
    for v in range(n_videos):
        vid = f"synthvid{v:03d}"
        vids.append(vid)
        rng = np.random.default_rng(seed * 7919 + v)
        # chapter starts: spread over the timeline, first at 0:00 like real
        # descriptions; parse_timestamp_block needs "0:00" on the first line
        starts = [0] + sorted(
            int(s) for s in rng.choice(
                np.arange(10, video_sec - 10), size=n_chapters - 1,
                replace=False,
            )
        )
        # per-chapter keywords (titles + in-chapter subtitle signal)
        kws = [
            [_WORDS[int(rng.integers(0, len(_WORDS)))] for _ in range(2)]
            for _ in starts
        ]
        lines = []
        for k, s in enumerate(starts):
            # learnable titles are corpus-vocabulary words only (they
            # recur in the chapter's subtitles, so a title model can
            # learn to extract them and corpus-built tokenizers encode
            # them as whole pieces)
            words = (f"{kws[k][0]} {kws[k][1]}" if learnable
                     else f"chapter {k} {_WORDS[k % len(_WORDS)]}")
            lines.append(f"{s // 60}:{s % 60:02d} {words}")
        rows.append((vid, f"synthetic video {v}", float(video_sec),
                     TIMESTAMP_DELIMITER.join(lines)))

        subs = _subtitles(rng, video_sec)
        if learnable:
            def chap_of(t):
                return int(np.searchsorted(starts, t, side="right")) - 1

            for entry in subs:
                k = chap_of(entry["start"])
                if int(entry["start"]) % 4 == 0:  # keyword sprinkle
                    entry["text"] += f" {kws[k][0]} {kws[k][1]}"
            for s in starts[1:]:  # boundary markers at the cut second
                k = chap_of(s)
                subs.append({
                    "text": " ".join(_MARKERS) +
                    f" {kws[k][0]} {kws[k][1]}",
                    "start": float(s),
                })
            subs.sort(key=lambda e: e["start"])
        sub_path = os.path.join(root, "dataset", "synth query",
                                f"subtitle_{vid}.json")
        with open(sub_path, "w") as f:
            json.dump(subs, f)

        vdir = os.path.join(img_dir, vid)
        os.makedirs(vdir, exist_ok=True)
        for t in range(1, video_sec + 1):  # 1-based %05d.jpg, 1 fps
            if learnable:
                # frame t covers second t-1; style keyed by its chapter
                k = int(np.searchsorted(starts, t - 1, side="right")) - 1
                style = (seed * 7919 + v) * 131 + k + 1
            else:
                style = 0
            Image.fromarray(
                synth_frame(seed * 7919 + v, t, hw, style=style)).save(
                os.path.join(vdir, "%05d.jpg" % t), quality=quality,
            )

    import csv

    with open(data_file, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["videoId", "title", "duration", "timestamp"])
        w.writerows(rows)
    if splits:
        i = 0
        for name in split_names:
            with open(vid_files[name], "w") as f:
                f.write("\n".join(vids[i:i + splits[name]]) + "\n")
            i += splits[name]
    else:
        with open(vid_files[split_names[0]], "w") as f:
            f.write("\n".join(vids) + "\n")
    with open(man_path, "w") as f:
        json.dump(manifest, f)
    return paths
