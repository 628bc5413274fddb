"""The reference's judgement of boundary scoring: the window model's clip
scores and the cut points of finished videos, recomputed from the raw
inputs and the benchmark's weights, then compared with what the program
served.

Readings (each the worst over the sample):
- score_gap: the largest |p_program - p_reference| of a clip's boundary
  probability;
- cut_mismatch: cut points in one list and not the other, where the
  reference's labels (p >= 0.5) take the program's label at clips whose
  reference probability lies within `ambiguous` of 0.5 (rounding may
  flip those).
The control is the reference itself run in a lower precision
(nets.Prec("fp8")), judged in the program's place by the same readings.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Sequence

import numpy as np
import torch

from . import host, nets


@torch.no_grad()
def window_logits(sd, cfg: dict, img_u8, ids, mask,
                  prec: nets.Prec = nets.FP32) -> torch.Tensor:
    """The window model's logits [B, 2]: img_u8 [B, W, T, H, W, 3] uint8,
    ids and mask [B, W, L]."""
    b, w, t = img_u8.shape[:3]
    _, pooled = nets.bert(sd, "lang_model.", ids.reshape(b * w, -1),
                          mask.reshape(b * w, -1), cfg["bert"], prec)
    vis = nets.resnet_tsm(img_u8.reshape(b * w * t, *img_u8.shape[3:]), sd,
                          "vision_model.", cfg["vision"], prec)
    return nets.window_head(sd, "", pooled.reshape(b, w, -1),
                            vis.reshape(b, w, t, -1), cfg["head"], prec)


def window_clip_inputs(video: dict, frames_dir: str, word_id,
                       window_size: int = 1):
    """(frame file paths, each target's frame indices [n, W, 16] with -1
    for a neighbour outside the video, ids and mask [n, W, 100]) of every
    target clip of a video: its neighbours 4 grid positions (16 s) away,
    as InferWindowClipDataset serves them."""
    n = video["duration"]
    starts = host.clip_starts(n)
    files = sorted({k for s in starts for k in host.clip_frame_files(s, n)})
    pos = {k: i for i, k in enumerate(files)}
    per_clip = [host.clip_text_ids(video["subtitles"], s, word_id)
                for s in starts]
    w = 2 * window_size + 1
    idx = np.full((len(starts), w, 16), -1, np.int64)
    ids = np.zeros((len(starts), w, per_clip[0][0].shape[0]), np.int64)
    masks = np.zeros_like(ids)
    for i in range(len(starts)):
        for j in range(w):
            c = i + (j - window_size) * 4
            if 0 <= c < len(starts):
                idx[i, j] = [pos[k] for k in host.clip_frame_files(
                    starts[c], n)]
                ids[i, j], masks[i, j] = per_clip[c]
    paths = [f"{frames_dir}/{video['vid']}/{k:05d}.jpg" for k in files]
    return paths, idx, ids, masks


def video_logits(sd, cfg: dict, video: dict, frames_dir: str, word_id,
                 hw: int, device, batch: int = 16,
                 precs: Sequence[nets.Prec] = (nets.FP32,),
                 rows=None) -> List[np.ndarray]:
    """Every target clip's logits [n, 2] (or those of `rows`) under each
    precision, in batches; each frame file decoded once, a neighbour
    outside the video all zeros."""
    paths, idx, ids, masks = window_clip_inputs(
        video, frames_dir, word_id, cfg["head"]["window_size"])
    if rows is not None:
        idx, ids, masks = idx[rows], ids[rows], masks[rows]
    frames = torch.from_numpy(np.concatenate(
        [host.load_frames(paths, hw), np.zeros((1, hw, hw, 3), np.uint8)]))
    idx = np.where(idx < 0, len(paths), idx)
    outs = [[] for _ in precs]
    for s in range(0, len(idx), batch):
        fr = frames[torch.from_numpy(idx[s:s + batch])].to(device)
        i = torch.from_numpy(ids[s:s + batch]).to(device)
        m = torch.from_numpy(masks[s:s + batch]).to(device)
        for k, prec in enumerate(precs):
            outs[k].append(window_logits(sd, cfg, fr, i, m, prec)
                           .double().cpu().numpy())
    return [np.concatenate(o) for o in outs]


def probs(logits: np.ndarray) -> np.ndarray:
    """The positive class's softmax probability of logits [n, 2]."""
    return 1.0 / (1.0 + np.exp(logits[:, 0] - logits[:, 1]))


def cut_points(p: np.ndarray) -> List[int]:
    """The cut points of clip probabilities, each clip's label p >= 0.5."""
    return host.cut_points((np.asarray(p) >= 0.5).astype(int).tolist())


def score_readings(p_prog: np.ndarray, p_ref: np.ndarray,
                   cuts_prog: Sequence[int], ambiguous: float) -> Dict:
    p_prog = np.asarray(p_prog, np.float64)
    if len(p_prog) != len(p_ref):
        return {"score_gap": float("inf"), "cut_mismatch": float("inf")}
    gap = float(np.max(np.abs(p_prog - p_ref))) if len(p_ref) else 0.0
    lab_ref = (p_ref >= 0.5).astype(int)
    near = np.abs(p_ref - 0.5) <= ambiguous
    lab_ref[near] = (p_prog[near] >= 0.5).astype(int)
    cuts_ref = host.cut_points(lab_ref.tolist())
    a, b = Counter(cuts_ref), Counter(int(c) for c in cuts_prog)
    mismatch = sum(((a - b) + (b - a)).values())
    return {"score_gap": gap, "cut_mismatch": float(mismatch)}
