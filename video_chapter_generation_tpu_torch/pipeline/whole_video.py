"""Per-video end-to-end chaptering: frames + subtitles -> clip scores ->
cut points -> chapter spans -> titles (counterpart of the JAX package's
pipeline/whole_video.py; the host logic is the same, the frame pack moves
to the device with a torch transfer)."""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.metrics import StepTimer
from ..data.clip_grid import chapter_spans, flatten_video_to_clips
from ..data.corpus import VideoCorpus
from ..data.datasets import InferClipDataset, _chapter_text
from ..data.frames import load_clip_frames
from ..data.loader import collate
from ..data.text_encode import encode_clip_text, encode_encoder_text
from ..device import resolve_device
from ..evalkit.boundary import convert_clip_label2cut_point
from .boundary import pack_to_device, score_clips


@dataclass
class VideoChapters:
    vid: str
    cut_points: List[int]
    spans: List
    titles: List[str]
    clip_scores: List[float] = field(default_factory=list)


class ChapterPipeline:
    """score_fn: batch dict -> positive prob [B] (with frame_pack=True:
    (batch, device pack) -> prob [B]); title_fn: (text_ids [B, L],
    attention_mask [B, L]) -> generated id rows; decode_fn: id row -> text.

    frame_pack=True: each video's unique frames are decoded once into a
    uint8 s2d pack that moves to `device` once, and clip batches carry
    [B, T] frame indices that gather on the device (clips at stride 4
    overlap 4x, so per-clip stacks would move 4x the bytes)."""

    def __init__(self, corpus: VideoCorpus, tokenizer, score_fn: Callable,
                 title_fn: Callable, decode_fn: Callable,
                 clip_frame_num: int = 16, max_text_len: int = 100,
                 title_input_len: int = 512, batch_size: int = 16,
                 score_mode: str = "text", fps: int = 1, hw: int = 224,
                 title_tokenizer=None, frame_pack: bool = False,
                 device: Optional[torch.device] = None):
        self.corpus = corpus
        self.tokenizer = tokenizer
        self.title_tokenizer = title_tokenizer or tokenizer
        self.score_fn = score_fn
        self.title_fn = title_fn
        self.decode_fn = decode_fn
        self.clip_frame_num = clip_frame_num
        self.max_text_len = max_text_len
        self.title_input_len = title_input_len
        self.batch_size = batch_size
        self.score_mode = score_mode
        self.fps = fps
        self.hw = hw
        self.frame_pack = frame_pack
        self.device = resolve_device(device)
        self.timer = StepTimer()

    def _clips(self, vid: str):
        return flatten_video_to_clips(
            vid, self.corpus.img_dir, self.corpus.image_num(vid),
            self.corpus.raw_cut_secs(vid), self.corpus.subtitles(vid),
            self.clip_frame_num, fps=self.fps)

    def _duration(self, vid: str) -> int:
        return round(self.corpus.records[vid].duration - 1)

    # -- stage 1: boundaries ------------------------------------------------
    def predict_cut_points(self, vid: str):
        ds = InferClipDataset(self._clips(vid), self.tokenizer,
                              self.max_text_len, mode=self.score_mode,
                              hw=self.hw)
        clips = score_clips(ds, self.score_fn, self.batch_size, self.timer)
        cut_points = convert_clip_label2cut_point(
            [c.pred_label for c in clips], self.clip_frame_num, 2 * self.fps)
        return cut_points, clips

    # -- stage 2: titles ----------------------------------------------------
    def generate_titles(self, vid: str,
                        cut_points: Sequence[int]) -> List[str]:
        spans = chapter_spans(list(cut_points), self._duration(vid))
        if not spans:
            return []
        subs = self.corpus.subtitles(vid)
        ids_rows, mask_rows = [], []
        for start_t, end_t in spans:
            text = _chapter_text(subs, start_t, end_t, self.fps)
            ids, mask = encode_encoder_text(text, self.title_tokenizer,
                                            self.title_input_len)
            ids_rows.append(ids)
            mask_rows.append(mask)
        self.timer.start("title_generate")
        gen_rows = self.title_fn(np.stack(ids_rows), np.stack(mask_rows))
        self.timer.stop("title_generate", len(spans))
        return [self.decode_fn(row) for row in gen_rows]

    # -- end to end ---------------------------------------------------------
    def run_video(self, vid: str) -> VideoChapters:
        self.timer.start("video_total")
        if self.frame_pack:
            out = self._finish_video(*self._prepare(vid))
        else:
            cut_points, clips = self.predict_cut_points(vid)
            out = VideoChapters(
                vid=vid, cut_points=list(cut_points),
                spans=chapter_spans(list(cut_points), self._duration(vid)),
                titles=self.generate_titles(vid, cut_points),
                clip_scores=[c.pred_score for c in clips])
        self.timer.stop("video_total", 1)
        return out

    def run(self, vids: Optional[Sequence[str]] = None,
            pipelined: bool = False,
            lookahead: int = 2) -> Dict[str, VideoChapters]:
        vids = list(vids or self.corpus.vids)
        if pipelined:
            return self.run_pipelined(vids, lookahead)
        return {vid: self.run_video(vid) for vid in vids}

    # -- pipelined mode -----------------------------------------------------
    def _prepare(self, vid: str):
        """Host stage: clip flattening, frame decode, tokenization; every
        score batch of one video prebuilt. Returns (vid, clip_infos,
        batches, frame_pack); frame_pack is None without frame_pack=True,
        and batches then carry stacked per-clip frames."""
        clips = self._clips(vid)
        if self.frame_pack:
            return (vid, *self._prepare_packed(clips))
        ds = InferClipDataset(clips, self.tokenizer, self.max_text_len,
                              mode=self.score_mode, hw=self.hw)
        n = len(ds)
        batches = []
        for start in range(0, n, self.batch_size):
            rows = list(range(start, min(start + self.batch_size, n)))
            items = [ds[i] for i in rows]
            items += [items[-1]] * (self.batch_size - len(rows))
            batches.append((rows, collate(items)))
        return vid, ds.all_clip_infos, batches, None

    def _prepare_packed(self, clips):
        """One s2d decode of the video's unique frames, per-clip text
        encodes and [B, T] gather indices into the pack."""
        paths: List[str] = []
        pos: Dict[str, int] = {}
        for c in clips:
            for p in c.image_paths:
                if p not in pos:
                    pos[p] = len(paths)
                    paths.append(p)
        pack = load_clip_frames(paths, self.hw, cache=None, s2d=True)
        items = []
        for c in clips:
            ids, mask = encode_clip_text(c.text_clip, self.tokenizer,
                                         self.max_text_len)
            items.append({
                "text_ids": ids,
                "attention_mask": mask,
                "frame_idx": np.asarray([pos[p] for p in c.image_paths],
                                        np.int32),
            })
        batches = []
        for start in range(0, len(items), self.batch_size):
            rows = list(range(start, min(start + self.batch_size, len(items))))
            chunk = [items[i] for i in rows]
            chunk += [chunk[-1]] * (self.batch_size - len(rows))
            batches.append((rows, collate(chunk)))
        return list(clips), batches, pack

    def _finish_video(self, vid: str, infos, batches,
                      frame_pack=None) -> VideoChapters:
        """Device stages: scoring over the prebuilt batches, cut points,
        titles. A frame pack moves host -> device once."""
        self.timer.start("device_score")
        if frame_pack is not None:
            pack = pack_to_device(frame_pack, self.device)
            score = lambda batch: self.score_fn(batch, pack)  # noqa: E731
        else:
            score = self.score_fn
        for rows, batch in batches:
            scores = np.asarray(torch.as_tensor(score(batch)).float().cpu())
            for j, i in enumerate(rows):
                infos[i].pred_score = float(scores[j])
                infos[i].pred_label = int(scores[j] >= 0.5)
        self.timer.stop("device_score", len(infos))
        cut_points = convert_clip_label2cut_point(
            [c.pred_label for c in infos], self.clip_frame_num, 2 * self.fps)
        return VideoChapters(
            vid=vid, cut_points=list(cut_points),
            spans=chapter_spans(list(cut_points), self._duration(vid)),
            titles=self.generate_titles(vid, cut_points),
            clip_scores=[c.pred_score for c in infos])

    def run_pipelined(self, vids: Sequence[str],
                      lookahead: int = 2) -> Dict[str, VideoChapters]:
        """Two videos in flight: a producer thread prepares video N+1
        (decode + tokenize) while the device scores and titles video N."""
        q: "queue.Queue" = queue.Queue(maxsize=lookahead)
        stop = object()
        failure: List[BaseException] = []

        def producer():
            try:
                for vid in vids:
                    q.put(self._prepare(vid))
            except Exception as e:  # re-raised on the consumer side
                failure.append(e)
            finally:
                q.put(stop)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        out: Dict[str, VideoChapters] = {}
        while True:
            item = q.get()
            if item is stop:
                break
            vid, infos, batches, pack = item
            self.timer.start("video_total")
            out[vid] = self._finish_video(vid, infos, batches, pack)
            self.timer.stop("video_total", 1)
        thread.join()
        if failure:
            raise failure[0]
        return out

    def videos_per_minute(self) -> float:
        return self.timer.rate("video_total") * 60.0


def bucket_title_fn(title_fn: Callable, multiple: int = 8) -> Callable:
    """Run title_fn over chunks of exactly `multiple` rows (the last chunk
    padded by repeating its final row; pad rows dropped), so one batch
    shape serves every video whatever its chapter count."""

    def fn(*arrays):
        arrays = [np.asarray(a) for a in arrays]
        n = arrays[0].shape[0]
        outs = []
        for start in range(0, n, multiple):
            chunk = [a[start:start + multiple] for a in arrays]
            k = chunk[0].shape[0]
            if k < multiple:
                chunk = [np.concatenate([c, np.repeat(c[-1:], multiple - k,
                                                      axis=0)])
                         for c in chunk]
            outs.append(np.asarray(title_fn(*chunk))[:k])
        return np.concatenate(outs, axis=0)

    return fn
