"""Batched boundary scoring (counterpart of the JAX package's
pipeline/boundary.py): the packed two-stream score function and the
plain per-clip scoring loop."""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from video_chapter_generation_tpu.core.metrics import StepTimer
from video_chapter_generation_tpu.data.clip_grid import ClipInfo
from video_chapter_generation_tpu.data.loader import collate

from ..models.fusion import TwoStream


def score_clips(dataset, score_fn: Callable[[Dict[str, np.ndarray]], object],
                batch_size: int = 16,
                timer: Optional[StepTimer] = None) -> List[ClipInfo]:
    """Run score_fn (batch dict -> positive-class prob [B]) over every clip
    of an InferClipDataset in static-shape batches (the last one padded by
    repeating its final row); fills pred_score / pred_label in place."""
    timer = timer or StepTimer()
    n = len(dataset)
    infos = dataset.all_clip_infos
    for start in range(0, n, batch_size):
        rows = list(range(start, min(start + batch_size, n)))
        items = [dataset[i] for i in rows]
        items += [items[-1]] * (batch_size - len(rows))
        timer.start("device_score")
        scores = np.asarray(torch.as_tensor(score_fn(collate(items))).cpu())
        timer.stop("device_score", len(rows))
        for j, i in enumerate(rows):
            infos[i].pred_score = float(scores[j])
            infos[i].pred_label = int(scores[j] >= 0.5)
    return infos


def pack_to_device(pack: np.ndarray, device: torch.device) -> torch.Tensor:
    """A video's uint8 s2d frame pack, moved once: pinned host memory and
    a non-blocking copy on the current stream (CPU: a plain tensor)."""
    host = torch.from_numpy(np.ascontiguousarray(pack))
    if device.type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host.to(device)


def make_packed_two_stream_score_fn(model: TwoStream, device: torch.device):
    """score(batch, pack) -> positive-class probability [B] float32 on the
    device, for ChapterPipeline(frame_pack=True). `pack` is the video's
    [N, hw/4, hw/4, 48] uint8 pack already on the device; the batch's
    [B, T] frame indices gather from it on the device, then vision, text,
    head and the softmax over the two classes."""

    def to_dev(a):
        return torch.as_tensor(a).to(device, non_blocking=True)

    @torch.no_grad()
    def score(batch, pack: torch.Tensor) -> torch.Tensor:
        idx = to_dev(batch["frame_idx"]).long()
        b, t = idx.shape
        vision = model.vision_model(pack[idx.reshape(-1)]).reshape(b, t, -1)
        _, pooled = model.lang_model(to_dev(batch["text_ids"]).long(),
                                     to_dev(batch["attention_mask"]))
        _, probs = model.head_probs(pooled, vision)
        return probs[:, 1]

    return score
