"""Dataset classes: torch-free, deterministic, numpy-batch producing.

The port's own copy of video_chapter_generation_tpu/data/datasets.py (the definitions the port uses;
each names the line it was copied from), so the port never imports
the JAX package.
"""

from __future__ import annotations
import json
import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple
import numpy as np
from ..core.metrics import span
from ..core.seeding import host_rng
from ..datasetkit.parsing import clean_str, remove_timestamp
from .clip_grid import (
    ClipInfo,
    build_clip_grid,
    chapter_spans,
    frame_indices_for_clip,
    label_clips,
    subtitle_text_for_window,
    valid_cut_points,
    window_clip_indices,
    window_skip_size,
)
from .corpus import VideoCorpus
from .frames import FRAME_HW, FrameCache, load_clip_frames
from .text_encode import (
    encode_clip_text,
    encode_encoder_text,
    encode_title_decoder,
)


def _video_clip_structure(corpus: VideoCorpus, vid: str, clip_frame_num: int,
                          fps: int = 1, cut_mode: str = "infer"):
    """Copied from video_chapter_generation_tpu/data/datasets.py:57."""
    image_num = corpus.image_num(vid)
    cut_points = valid_cut_points(
        corpus.raw_cut_secs(vid), image_num, fps=fps, mode=cut_mode
    )
    max_offset = 2 * fps
    clips = build_clip_grid(image_num, clip_frame_num, max_offset)
    labels = label_clips(clips, cut_points, clip_frame_num, max_offset)
    return image_num, cut_points, clips, labels


def _clip_images(corpus, vid, clip, image_num, clip_frame_num, hw, cache):
    """Copied from video_chapter_generation_tpu/data/datasets.py:69."""
    start, end = clip
    idx = frame_indices_for_clip(start, end, image_num, clip_frame_num)
    paths = [corpus.frame_path(vid, i) for i in idx]
    return load_clip_frames(paths, hw, cache)


class ClipDataset:
    """Training sampler: one positive-or-negative clip per video per epoch.

    Copied from video_chapter_generation_tpu/data/datasets.py:76.
    """

    def __init__(self, corpus: VideoCorpus, tokenizer, clip_frame_num: int = 16,
                 max_text_len: int = 100, mode: str = "all", fps: int = 1,
                 seed: int = 123, hw: int = FRAME_HW, s2d: bool = False):
        self.corpus = corpus
        self.tokenizer = tokenizer
        self.clip_frame_num = clip_frame_num
        self.max_text_len = max_text_len
        self.mode = mode
        self.fps = fps
        self.seed = seed
        self.hw = hw
        self.s2d = s2d  # emit uint8 4x4 space-to-depth (stem_input="s2d")
        self.cache = FrameCache()

    def __len__(self):
        return len(self.corpus.vids)

    def __getitem__(self, i: int, epoch: int = 0) -> Dict[str, np.ndarray]:
        rng = host_rng(self.seed, epoch, i)
        vid = self.corpus.vids[i]
        # NOTE: the train variant keeps cut points up to image_num
        # (youtube_dataset.py:82-87)
        image_num, cut_points, clips, labels = _video_clip_structure(
            self.corpus, vid, self.clip_frame_num, self.fps, cut_mode="train"
        )
        pos = np.flatnonzero(labels == 1)
        neg = np.flatnonzero(labels == 0)
        is_positive = int(rng.integers(0, 2)) if len(pos) else 0
        pool = pos if is_positive else neg
        target = int(pool[rng.integers(0, len(pool))])
        clip = clips[target]

        text = subtitle_text_for_window(
            self.corpus.subtitles(vid), clip[0], clip[1], 1 * self.fps,
            fps=self.fps,
        )
        ids, mask = encode_clip_text(text, self.tokenizer, self.max_text_len)
        out = {
            "text_ids": ids,
            "attention_mask": mask,
            "label": np.int32(is_positive),
        }
        if self.mode != "text":
            imgs = _clip_images(
                self.corpus, vid, clip, image_num, self.clip_frame_num,
                self.hw, self.cache,
            )
            if self.s2d:
                from .frames import space_to_depth4

                imgs = space_to_depth4(imgs)
            out["img_clip"] = imgs
        return out


class WindowClipDataset:
    """Flagship training sampler: target clip ± window at skip_size.

    Copied from video_chapter_generation_tpu/data/datasets.py:134.
    """

    def __init__(self, corpus: VideoCorpus, tokenizer, clip_frame_num: int = 16,
                 max_text_len: int = 100, window_size: int = 1,
                 mode: str = "all", fps: int = 1, seed: int = 123,
                 hw: int = FRAME_HW, s2d: bool = False):
        self.corpus = corpus
        self.tokenizer = tokenizer
        self.clip_frame_num = clip_frame_num
        self.max_text_len = max_text_len
        self.window_size = window_size
        self.mode = mode
        self.fps = fps
        self.seed = seed
        self.hw = hw
        self.s2d = s2d  # emit uint8 4x4 space-to-depth (stem_input="s2d")
        self.cache = FrameCache()

    def __len__(self):
        return len(self.corpus.vids)

    def _encode_window(self, vid, clips, image_num, window_indices):
        subs = self.corpus.subtitles(vid)
        W = len(window_indices)
        T, hw = self.clip_frame_num, self.hw
        text_ids = np.zeros((W, self.max_text_len), np.int32)
        masks = np.zeros((W, self.max_text_len), np.int32)
        imgs = (
            np.zeros((W, T, hw, hw, 3), np.uint8)
            if self.mode != "text" else None
        )
        starts = np.full((W,), -1, np.int32)
        for w, idx in enumerate(window_indices):
            if idx == -1:
                continue  # zero padding (youtube_dataset.py:459-470)
            clip = clips[idx]
            starts[w] = clip[0]
            text = subtitle_text_for_window(
                subs, clip[0], clip[1], 1 * self.fps, fps=self.fps
            )
            ids, m = encode_clip_text(text, self.tokenizer, self.max_text_len)
            text_ids[w], masks[w] = ids, m
            if imgs is not None:
                imgs[w] = _clip_images(
                    self.corpus, vid, clip, image_num, self.clip_frame_num,
                    self.hw, self.cache,
                )
        return imgs, text_ids, masks, starts

    def __getitem__(self, i: int, epoch: int = 0) -> Dict[str, np.ndarray]:
        rng = host_rng(self.seed, epoch, i)
        vid = self.corpus.vids[i]
        # window variant filters cut points to [4, image_num-4]
        # (youtube_dataset.py:404-408)
        image_num, cut_points, clips, labels = _video_clip_structure(
            self.corpus, vid, self.clip_frame_num, self.fps, cut_mode="infer"
        )
        pos = np.flatnonzero(labels == 1)
        neg = np.flatnonzero(labels == 0)
        is_positive = int(rng.integers(0, 2)) if len(pos) else 0
        pool = pos if is_positive else neg
        target = int(pool[rng.integers(0, len(pool))])

        skip = window_skip_size(self.clip_frame_num, 2 * self.fps)
        win = window_clip_indices(target, len(clips), self.window_size, skip)
        imgs, text_ids, masks, starts = self._encode_window(
            vid, clips, image_num, win
        )
        if imgs is not None and self.s2d:
            from .frames import space_to_depth4

            imgs = space_to_depth4(imgs)
        out = {
            "text_ids": text_ids,
            "attention_mask": masks,
            "label": np.int32(is_positive),
            "clip_start_frame": starts,
            "total_frames": np.int32(image_num),
            "target_clip_idx": np.int32(target),
            "total_num_clips": np.int32(len(clips)),
        }
        if imgs is not None:
            out["img_clips"] = imgs
        return out


class InferClipDataset:
    """Sequential eval over precomputed flattened clips (the workhorse).

    Copied from video_chapter_generation_tpu/data/datasets.py:221.
    """

    def __init__(self, clips: Sequence[ClipInfo], tokenizer,
                 max_text_len: int = 100, mode: str = "all",
                 hw: int = FRAME_HW):
        self.all_clip_infos = list(clips)
        self.tokenizer = tokenizer
        self.max_text_len = max_text_len
        self.mode = mode
        self.hw = hw
        self.cache = FrameCache()

    @classmethod
    def from_json(cls, path: str, tokenizer, **kw) -> "InferClipDataset":
        with open(path) as f:
            data = json.load(f)
        return cls([ClipInfo.from_json(d) for d in data], tokenizer, **kw)

    def __len__(self):
        return len(self.all_clip_infos)

    def __getitem__(self, i: int, epoch: int = 0) -> Dict[str, np.ndarray]:
        info = self.all_clip_infos[i]
        ids, mask = encode_clip_text(
            info.text_clip, self.tokenizer, self.max_text_len
        )
        out = {
            "text_ids": ids,
            "attention_mask": mask,
            "label": np.int32(info.clip_label),
            "clip_index": np.int32(i),
        }
        if self.mode != "text":
            out["img_clip"] = load_clip_frames(
                info.image_paths, self.hw, self.cache
            )
        return out


class InferWindowClipDataset(InferClipDataset):
    """Eval with window context: groups flattened clips by video and serves
    target ± window neighbors (infer_youtube_video_dataset.py:429-577).
    On the thread's current timer (core/metrics.py) an item records each
    clip's text encoding ("tokens", a text) and its frames from the
    cache into the window ("frames", its frames; decodes are children).

    Copied from video_chapter_generation_tpu/data/datasets.py:261.
    """

    def __init__(self, clips: Sequence[ClipInfo], tokenizer,
                 clip_frame_num: int = 16, max_text_len: int = 100,
                 window_size: int = 1, mode: str = "all", fps: int = 1,
                 hw: int = FRAME_HW):
        super().__init__(clips, tokenizer, max_text_len, mode, hw)
        self.clip_frame_num = clip_frame_num
        self.window_size = window_size
        self.fps = fps
        # group flat indices by vid (clips are stored video-contiguous)
        self.vid_to_range: Dict[str, Tuple[int, int]] = {}
        for idx, info in enumerate(self.all_clip_infos):
            if info.vid not in self.vid_to_range:
                self.vid_to_range[info.vid] = (idx, idx + 1)
            else:
                s, _ = self.vid_to_range[info.vid]
                self.vid_to_range[info.vid] = (s, idx + 1)
        # per-video frame count for clips_info: the flattened-clips JSON
        # carries no image_num, so recover it as the max clip end — the
        # reference's own fallback (infer_youtube_video_dataset.py:645)
        self.vid_to_total_frames: Dict[str, int] = {
            vid: max(self.all_clip_infos[k].clip_start_end[1]
                     for k in range(s, e))
            for vid, (s, e) in self.vid_to_range.items()
        }

    def __getitem__(self, i: int, epoch: int = 0) -> Dict[str, np.ndarray]:
        info = self.all_clip_infos[i]
        start, end = self.vid_to_range[info.vid]
        n_clips = end - start
        local = i - start
        skip = window_skip_size(self.clip_frame_num, 2 * self.fps)
        win = window_clip_indices(local, n_clips, self.window_size, skip)

        W = len(win)
        text_ids = np.zeros((W, self.max_text_len), np.int32)
        masks = np.zeros((W, self.max_text_len), np.int32)
        imgs = (
            np.zeros((W, self.clip_frame_num, self.hw, self.hw, 3), np.uint8)
            if self.mode != "text" else None
        )
        starts = np.full((W,), -1, np.int32)
        for w, idx in enumerate(win):
            if idx == -1:
                continue
            ci = self.all_clip_infos[start + idx]
            with span("tokens"):
                ids, m = encode_clip_text(
                    ci.text_clip, self.tokenizer, self.max_text_len
                )
            text_ids[w], masks[w] = ids, m
            starts[w] = ci.clip_start_end[0]
            if imgs is not None:
                with span("frames", len(ci.image_paths)):
                    imgs[w] = load_clip_frames(ci.image_paths, self.hw,
                                               self.cache)

        out = {
            "text_ids": text_ids,
            "attention_mask": masks,
            "label": np.int32(info.clip_label),
            "clip_index": np.int32(i),
            "clip_start_frame": starts,
            "total_frames": np.int32(self.vid_to_total_frames[info.vid]),
            "target_clip_idx": np.int32(local),
            "total_num_clips": np.int32(n_clips),
        }
        if imgs is not None:
            out["img_clips"] = imgs
        return out


def _chapter_text(subtitles, start_t, end_t, fps: int = 1) -> str:
    """Copied from video_chapter_generation_tpu/data/datasets.py:338."""
    text = subtitle_text_for_window(
        subtitles, start_t, end_t, 1 * fps, fps=fps, early_stop=True
    )
    return " ".join(text.split()).lower()


def _clean_title(description: str) -> str:
    """Copied from video_chapter_generation_tpu/data/datasets.py:345."""
    return remove_timestamp(clean_str(description)).lower()


class ChapterTitleDataset:
    """Random chapter per video -> (chapter subtitles, cleaned title).

    Copied from video_chapter_generation_tpu/data/datasets.py:349.
    """

    def __init__(self, corpus: VideoCorpus, tokenizer, max_text_len: int = 512,
                 chapter_title_text_len: int = 30, seed: int = 123,
                 fps: int = 1):
        self.corpus = corpus
        self.tokenizer = tokenizer
        self.max_text_len = max_text_len
        self.chapter_title_text_len = chapter_title_text_len
        self.seed = seed
        self.fps = fps

    def __len__(self):
        return len(self.corpus.vids)

    def _encode(self, vid, chapter_idx) -> Dict[str, np.ndarray]:
        rec = self.corpus.records[vid]
        chapters = self.corpus.chapter_descriptions(vid)
        duration = round(rec.duration - 1)
        secs = [c[0] for c in chapters]
        spans = chapter_spans(secs, duration)
        start_t, end_t = spans[chapter_idx]
        title = _clean_title(chapters[chapter_idx][1])
        text = _chapter_text(self.corpus.subtitles(vid), start_t, end_t,
                             self.fps)
        ids, mask = encode_encoder_text(text, self.tokenizer,
                                        self.max_text_len)
        dec = encode_title_decoder(title, self.tokenizer,
                                   self.chapter_title_text_len)
        return {
            "text_ids": ids,
            "attention_mask": mask,
            **dec,
            "chapter_start": np.int32(start_t),
            "chapter_end": np.int32(end_t),
        }

    def __getitem__(self, i: int, epoch: int = 0) -> Dict[str, np.ndarray]:
        rng = host_rng(self.seed, epoch, i)
        vid = self.corpus.vids[i]
        n = len(self.corpus.records[vid].timestamp_lines)
        chapter_idx = int(rng.integers(0, n))
        return self._encode(vid, chapter_idx)


class AllChapterTitleDataset(ChapterTitleDataset):
    """ALL chapters of every video (eval). With `vid2cut_points`, chapters
    come from PREDICTED cut points instead of GT (the end-to-end eval,
    youtube_chapter_title_dataset.py:521-760); titles are then matched to
    the nearest GT chapter for scoring.

    Copied from video_chapter_generation_tpu/data/datasets.py:395.
    """

    def __init__(self, corpus, tokenizer, max_text_len=512,
                 chapter_title_text_len=30, fps: int = 1,
                 vid2cut_points: Optional[Dict[str, List[int]]] = None):
        super().__init__(corpus, tokenizer, max_text_len,
                         chapter_title_text_len, fps=fps)
        self.items: List[Tuple[str, int, Optional[Tuple[int, float]]]] = []
        self.vid2cut_points = vid2cut_points
        for vid in corpus.vids:
            if vid2cut_points is None:
                n = len(corpus.records[vid].timestamp_lines)
                self.items += [(vid, k, None) for k in range(n)]
            else:
                cps = vid2cut_points.get(vid, [])
                duration = round(corpus.records[vid].duration - 1)
                for k, span in enumerate(chapter_spans(list(cps), duration)):
                    self.items.append((vid, k, span))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i: int, epoch: int = 0) -> Dict[str, np.ndarray]:
        vid, k, span = self.items[i]
        if span is None:
            out = self._encode(vid, k)
            out["item_index"] = np.int32(i)
            return out
        # predicted span: encoder text from the span; target title = nearest
        # GT chapter's title
        start_t, end_t = span
        chapters = self.corpus.chapter_descriptions(vid)
        nearest = min(chapters, key=lambda c: abs(c[0] - start_t))
        title = _clean_title(nearest[1])
        text = _chapter_text(self.corpus.subtitles(vid), start_t, end_t,
                             self.fps)
        ids, mask = encode_encoder_text(text, self.tokenizer,
                                        self.max_text_len)
        dec = encode_title_decoder(title, self.tokenizer,
                                   self.chapter_title_text_len)
        return {
            "text_ids": ids, "attention_mask": mask, **dec,
            "chapter_start": np.int32(start_t),
            "chapter_end": np.int32(end_t), "item_index": np.int32(i),
        }


class _VisionEmbMixin:
    """Shared vision-emb attachment: emb_provider(vid, start, end) ->
    list of per-block [T, D] (mean-pooled here) or [D] arrays; padded to
    max_vision_emb with a validity mask
    (youtube_chapter_title_dataset.py:222-248, :424-450).

    Copied from video_chapter_generation_tpu/data/datasets.py:446.
    """

    def _attach_vision(self, out: Dict[str, np.ndarray],
                       vid: str) -> Dict[str, np.ndarray]:
        embs = self.emb_provider(
            vid, int(out["chapter_start"]), int(out["chapter_end"])
        )
        out["vision_embs"], out["vision_attention_mask"] = \
            chapter_vision_embs(embs, self.max_vision_emb, self.emb_dim)
        return out


class ChapterTitleVisionEmbDataset(_VisionEmbMixin, ChapterTitleDataset):
    """Random-chapter title dataset + per-16s-block vision embeddings
    (youtube_chapter_title_dataset.py:162-290).

    Copied from video_chapter_generation_tpu/data/datasets.py:468.
    """

    def __init__(self, corpus, tokenizer, emb_provider: Callable,
                 max_vision_emb: int = 10, emb_dim: int = 2048, **kw):
        super().__init__(corpus, tokenizer, **kw)
        self.emb_provider = emb_provider
        self.max_vision_emb = max_vision_emb
        self.emb_dim = emb_dim

    def __getitem__(self, i: int, epoch: int = 0) -> Dict[str, np.ndarray]:
        out = super().__getitem__(i, epoch)
        return self._attach_vision(out, self.corpus.vids[i])


class AllChapterTitleVisionEmbDataset(_VisionEmbMixin, AllChapterTitleDataset):
    """ALL chapters (GT or predicted cut points) + vision embeddings — the
    eval dataset of test_chapter_title_gen_vision_emb.py
    (youtube_chapter_title_dataset.py:330-517 with vision_emb_dir set).

    Copied from video_chapter_generation_tpu/data/datasets.py:484.
    """

    def __init__(self, corpus, tokenizer, emb_provider: Callable,
                 max_vision_emb: int = 10, emb_dim: int = 2048, **kw):
        super().__init__(corpus, tokenizer, **kw)
        self.emb_provider = emb_provider
        self.max_vision_emb = max_vision_emb
        self.emb_dim = emb_dim

    def __getitem__(self, i: int, epoch: int = 0) -> Dict[str, np.ndarray]:
        out = super().__getitem__(i, epoch)
        return self._attach_vision(out, self.items[i][0])


def chapter_vision_embs(embs, max_vision_emb: int = 10, emb_dim: int = 2048
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """One chapter's vision embeddings as the title model takes them: each
    per-block [T, D] array mean-pooled over T (a [D] one as it is), the
    first max_vision_emb of them in float32 [max_vision_emb, emb_dim],
    zero rows after, and the int32 validity mask [max_vision_emb].

    The attachment of video_chapter_generation_tpu/data/datasets.py:446-465
    (_VisionEmbMixin._attach_vision), which its
    pipeline/whole_video.py:101-110 repeats inline.
    """
    vis = np.zeros((max_vision_emb, emb_dim), np.float32)
    mask = np.zeros((max_vision_emb,), np.int32)
    for k, e in enumerate(embs[:max_vision_emb]):
        e = np.asarray(e)
        vis[k] = e.mean(axis=0) if e.ndim == 2 else e
        mask[k] = 1
    return vis, mask


def vision_emb_block_range(chapter_start: int, chapter_end: int,
                           block_sec: int = 16) -> range:
    """The reference's chapter -> 16s-block selection
    (youtube_chapter_title_dataset.py:224-233): quantize the chapter span
    to the 4s clip grid, last block must END inside the span, and a
    too-short chapter degenerates to one block at the (clamped) start.

    Copied from video_chapter_generation_tpu/data/datasets.py:501.
    """
    start = (int(chapter_start) // 4) * 4
    end = (int(chapter_end) // 4) * 4 - block_sec
    if end < 0:
        end = start
    if start > end:
        start = end
    return range(start, end + 1, block_sec)


def npy_vision_emb_provider(emb_dir: str, block_sec: int = 16) -> Callable:
    """Serve the convert2vision_emb.py on-disk layout
    (<emb_dir>/<vid>/vision_emb_<start>_<end>.npy per clip) with the
    reference's chapter->block selection. Missing block files are skipped
    (the clip grid `range(0, image_num - N, 4)` can lack the final block
    for some durations; the reference would crash there).

    Copied from video_chapter_generation_tpu/data/datasets.py:516.
    """

    def provider(vid: str, chapter_start: int, chapter_end: int):
        out = []
        for st in vision_emb_block_range(chapter_start, chapter_end,
                                         block_sec):
            path = os.path.join(
                emb_dir, vid, f"vision_emb_{st}_{st + block_sec}.npy"
            )
            if os.path.exists(path):
                out.append(np.load(path))
        return out

    return provider


# ignore-index for token losses (youtube_dataset.py:20; JAX data/datasets.py:54)
Y_PAD = -1


def mlm_mask(ids: np.ndarray, attention_mask: np.ndarray, vocab_size: int,
             mask_token_id: int, rng, special_ids=(),
             mask_prob: float = 0.15) -> Tuple[np.ndarray, np.ndarray]:
    """BERT MLM corruption (youtube_subtitle_dataset.py:349-402): select 15%
    of real tokens; 80% -> [MASK], 10% -> random token, 10% -> keep.
    Returns (corrupted_ids, targets with Y_PAD elsewhere).

    Copied from video_chapter_generation_tpu/data/datasets.py:543.
    """
    ids = ids.copy()
    targets = np.full_like(ids, Y_PAD)
    candidates = np.flatnonzero(
        (attention_mask == 1) & ~np.isin(ids, list(special_ids))
    )
    n = max(1, int(round(len(candidates) * mask_prob))) if len(candidates) else 0
    if n == 0:
        return ids, targets
    chosen = rng.choice(candidates, size=n, replace=False)
    targets[chosen] = ids[chosen]
    roll = rng.random(n)
    for pos, r in zip(chosen, roll):
        if r < 0.8:
            ids[pos] = mask_token_id
        elif r < 0.9:
            ids[pos] = int(rng.integers(0, vocab_size))
        # else keep
    return ids, targets


class SubtitlePretrainDataset:
    """Random 16 s subtitle window per video; BERT-MLM or GPT next-token.

    Copied from video_chapter_generation_tpu/data/datasets.py:569.
    """

    def __init__(self, corpus: VideoCorpus, tokenizer, task: str = "mlm",
                 window_sec: int = 16, max_text_len: int = 100,
                 seed: int = 123):
        assert task in ("mlm", "next_token")
        self.corpus = corpus
        self.tokenizer = tokenizer
        self.task = task
        self.window_sec = window_sec
        self.max_text_len = max_text_len
        self.seed = seed

    def __len__(self):
        return len(self.corpus.vids)

    def _window_text(self, vid: str, rng) -> str:
        image_num = self.corpus.image_num(vid)
        hi = max(1, image_num - self.window_sec)
        start = int(rng.integers(0, hi))
        return subtitle_text_for_window(
            self.corpus.subtitles(vid), start, start + self.window_sec
        )

    def __getitem__(self, i: int, epoch: int = 0) -> Dict[str, np.ndarray]:
        rng = host_rng(self.seed, epoch, i)
        vid = self.corpus.vids[i]
        text = self._window_text(vid, rng)
        ids, mask = encode_clip_text(text, self.tokenizer, self.max_text_len)
        if self.task == "next_token":
            # position t's target is token t + 1, and the model that takes
            # these items (LangPretrainTask) is the bidirectional BERT: each
            # position sees the token it must predict, as in the JAX
            # package (data/datasets.py:599-603), which this reproduces
            targets = np.full_like(ids, Y_PAD)
            real = np.flatnonzero(mask == 1)
            if len(real) > 1:
                targets[real[:-1]] = ids[real[1:]]
            return {"text_ids": ids, "attention_mask": mask,
                    "targets": targets}
        specials = self.tokenizer.convert_tokens_to_ids(
            [self.tokenizer.cls_token, self.tokenizer.pad_token]
        )
        mask_id = self.tokenizer.convert_tokens_to_ids(
            [self.tokenizer.mask_token]
        )[0]
        corrupted, targets = mlm_mask(
            ids, mask, self.tokenizer.vocab_size, mask_id, rng, specials
        )
        return {"text_ids": corrupted, "attention_mask": mask,
                "targets": targets}


class GloveSubtitleDataset:
    """GloVe-embedding next-token pretraining sampler for the from-scratch
    GPT (youtube_subtitle_dataset.py:31-141): random 16s window per video,
    subtitles within +-4s, lowercase + decontracted, known-vocab words
    only; inputs are the word EMBEDDINGS shifted by one against the id
    targets (x = emb[:-1], y = ids[1:]), zero/Y_PAD padded.

    Copied from video_chapter_generation_tpu/data/datasets.py:678.
    """

    def __init__(self, corpus: VideoCorpus, token2embedding: Dict,
                 vocab: Sequence[str], clip_frame_num: int = 16,
                 max_text_len: int = 100, emb_dim: int = 300,
                 seed: int = 123):
        from ..datasetkit.parsing import text_decontracted

        self._decontract = text_decontracted
        self.corpus = corpus
        self.token2embedding = token2embedding
        self.token2id = {t: i for i, t in enumerate(vocab)}
        self.vocab_size = len(vocab)
        self.clip_frame_num = clip_frame_num
        self.half = clip_frame_num // 2
        self.max_text_len = max_text_len
        self.emb_dim = emb_dim
        self.seed = seed

    def __len__(self):
        return len(self.corpus.vids)

    def __getitem__(self, i: int, epoch: int = 0) -> Dict[str, np.ndarray]:
        rng = host_rng(self.seed, epoch, i)
        vid = self.corpus.vids[i]
        image_num = self.corpus.image_num(vid)
        t = int(rng.integers(self.half, max(self.half + 1,
                                            image_num - self.half)))
        start, end = t - self.half, t + self.half
        # text_extra_time_gap = 4 (youtube_subtitle_dataset.py:93)
        text = subtitle_text_for_window(self.corpus.subtitles(vid),
                                        start, end, time_gap=4)
        text = self._decontract(text.lower())

        embs, ids = [], []
        for w in text.split(" "):
            if w and w in self.token2id:
                e = self.token2embedding.get(w)
                embs.append(np.zeros(self.emb_dim, np.float32)
                            if e is None else np.asarray(e, np.float32))
                ids.append(self.token2id[w])

        x = np.zeros((self.max_text_len, self.emb_dim), np.float32)
        y = np.full((self.max_text_len,), Y_PAD, np.int64)
        n = min(max(len(embs) - 1, 0), self.max_text_len)
        if n:
            x[:n] = np.stack(embs[:n])
            y[:n] = ids[1 : n + 1]
        return {"embeddings": x, "targets": y.astype(np.int32)}


class WordIdSubtitleDataset(GloveSubtitleDataset):
    """Token-ID next-token variant for the from-scratch GPT WITHOUT GloVe
    (the reference's pretrain_lang_model.py use_glove_emb=False path):
    same random 16s window / lowercase / decontract / known-vocab filter
    as the GloVe sampler, but x = ids[:-1] and y = ids[1:] as int ids.

    Copied from video_chapter_generation_tpu/data/datasets.py:734.
    """

    def __init__(self, corpus: VideoCorpus, vocab: Sequence[str],
                 clip_frame_num: int = 16, max_text_len: int = 100,
                 seed: int = 123):
        super().__init__(corpus, {}, vocab, clip_frame_num=clip_frame_num,
                         max_text_len=max_text_len, seed=seed)

    def __getitem__(self, i: int, epoch: int = 0) -> Dict[str, np.ndarray]:
        rng = host_rng(self.seed, epoch, i)
        vid = self.corpus.vids[i]
        image_num = self.corpus.image_num(vid)
        t = int(rng.integers(self.half, max(self.half + 1,
                                            image_num - self.half)))
        start, end = t - self.half, t + self.half
        text = subtitle_text_for_window(self.corpus.subtitles(vid),
                                        start, end, time_gap=4)
        text = self._decontract(text.lower())
        ids = [self.token2id[w] for w in text.split(" ")
               if w and w in self.token2id]

        x = np.zeros((self.max_text_len,), np.int64)
        y = np.full((self.max_text_len,), Y_PAD, np.int64)
        n = min(max(len(ids) - 1, 0), self.max_text_len)
        if n:
            x[:n] = ids[:n]
            y[:n] = ids[1 : n + 1]
        return {"text_ids": x.astype(np.int32), "targets": y.astype(np.int32)}


class ListwiseSlateDataset:
    """2 positives + k negatives per video (YoutubeListwiseClipDataset,
    youtube_dataset.py:1195-1388): slot 0 = a positive clip; contrast slots
    = 1 positive + k negatives; relevance one-hot on the contrast positive.

    Copied from video_chapter_generation_tpu/data/datasets.py:619.
    """

    def __init__(self, corpus, tokenizer, clip_frame_num=16, max_text_len=100,
                 num_negatives=4, seed=123, fps=1):
        self.corpus = corpus
        self.tokenizer = tokenizer
        self.clip_frame_num = clip_frame_num
        self.max_text_len = max_text_len
        self.num_negatives = num_negatives
        self.seed = seed
        self.fps = fps

    def __len__(self):
        return len(self.corpus.vids)

    def __getitem__(self, i: int, epoch: int = 0) -> Dict[str, np.ndarray]:
        rng = host_rng(self.seed, epoch, i)
        vid = self.corpus.vids[i]
        image_num, _, clips, labels = _video_clip_structure(
            self.corpus, vid, self.clip_frame_num, self.fps, "infer"
        )
        pos = np.flatnonzero(labels == 1)
        neg = np.flatnonzero(labels == 0)
        slate_len = 2 + self.num_negatives
        subs = self.corpus.subtitles(vid)

        if len(pos) == 0:  # degenerate video: all-negative slate
            chosen = list(rng.choice(neg, size=slate_len, replace=True))
            relevance = np.zeros(slate_len, np.float32)
        else:
            p = rng.choice(pos, size=2, replace=len(pos) < 2)
            n = rng.choice(neg, size=self.num_negatives,
                           replace=len(neg) < self.num_negatives)
            contrast = list(n) + [int(p[1])]
            rng.shuffle(contrast)
            chosen = [int(p[0])] + contrast
            relevance = np.zeros(slate_len, np.float32)
            relevance[1 + contrast.index(int(p[1]))] = 1.0

        ids = np.zeros((slate_len, self.max_text_len), np.int32)
        masks = np.zeros_like(ids)
        slate_labels = np.zeros(slate_len, np.int32)
        for k, ci in enumerate(chosen):
            text = subtitle_text_for_window(
                subs, clips[ci][0], clips[ci][1], 1 * self.fps, fps=self.fps
            )
            ids[k], masks[k] = encode_clip_text(
                text, self.tokenizer, self.max_text_len
            )
            slate_labels[k] = labels[ci]
        return {
            "text_ids": ids, "attention_mask": masks,
            "relevance": relevance, "slate_labels": slate_labels,
        }


class ContrastiveSubtitleDataset(SubtitlePretrainDataset):
    """MoCo pairs: query window + neighboring windows as positive candidates
    (youtube_subtitle_dataset.py:415-614).

    Copied from video_chapter_generation_tpu/data/datasets.py:768.
    """

    def __init__(self, corpus, tokenizer, num_candidates: int = 4, **kw):
        super().__init__(corpus, tokenizer, task="mlm", **kw)
        self.num_candidates = num_candidates

    def __getitem__(self, i: int, epoch: int = 0) -> Dict[str, np.ndarray]:
        rng = host_rng(self.seed, epoch, i)
        vid = self.corpus.vids[i]
        image_num = self.corpus.image_num(vid)
        hi = max(1, image_num - self.window_sec)
        start = int(rng.integers(0, hi))
        subs = self.corpus.subtitles(vid)

        q_text = subtitle_text_for_window(subs, start, start + self.window_sec)
        q_ids, q_mask = encode_clip_text(q_text, self.tokenizer,
                                         self.max_text_len)

        cand_ids = np.zeros((self.num_candidates, self.max_text_len), np.int32)
        cand_mask = np.zeros_like(cand_ids)
        for k in range(self.num_candidates):
            off = int(rng.integers(1, self.window_sec)) * (
                1 if rng.random() < 0.5 else -1
            )
            s = int(np.clip(start + off, 0, hi))
            text = subtitle_text_for_window(subs, s, s + self.window_sec)
            cand_ids[k], cand_mask[k] = encode_clip_text(
                text, self.tokenizer, self.max_text_len
            )
        return {
            "query_ids": q_ids, "query_mask": q_mask,
            "cand_ids": cand_ids, "cand_mask": cand_mask,
        }


class AllClipDataset:
    """ALL clips of one video + a sampled target index per epoch
    (YoutubeAllClipDataset, youtube_dataset.py:199-357). Returns text for
    every clip of the video, padded to max_clips, with the target clip's
    label — the sampler used by slate-style training.

    Copied from video_chapter_generation_tpu/data/datasets.py:805.
    """

    def __init__(self, corpus: VideoCorpus, tokenizer, clip_frame_num: int = 16,
                 max_text_len: int = 100, max_clips: int = 128, fps: int = 1,
                 seed: int = 123):
        self.corpus = corpus
        self.tokenizer = tokenizer
        self.clip_frame_num = clip_frame_num
        self.max_text_len = max_text_len
        self.max_clips = max_clips
        self.fps = fps
        self.seed = seed

    def __len__(self):
        return len(self.corpus.vids)

    def __getitem__(self, i: int, epoch: int = 0) -> Dict[str, np.ndarray]:
        rng = host_rng(self.seed, epoch, i)
        vid = self.corpus.vids[i]
        image_num, cut_points, clips, labels = _video_clip_structure(
            self.corpus, vid, self.clip_frame_num, self.fps, "infer"
        )
        subs = self.corpus.subtitles(vid)
        n = min(len(clips), self.max_clips)
        text_ids = np.zeros((self.max_clips, self.max_text_len), np.int32)
        masks = np.zeros_like(text_ids)
        clip_labels = np.full((self.max_clips,), -1, np.int32)
        for k in range(n):
            text = subtitle_text_for_window(
                subs, clips[k][0], clips[k][1], 1 * self.fps, fps=self.fps
            )
            text_ids[k], masks[k] = encode_clip_text(
                text, self.tokenizer, self.max_text_len
            )
            clip_labels[k] = labels[k]
        target = int(rng.integers(0, n))
        return {
            "text_ids": text_ids,
            "attention_mask": masks,
            "clip_labels": clip_labels,
            "target_clip_idx": np.int32(target),
            "label": np.int32(labels[target]),
            "num_clips": np.int32(n),
        }
