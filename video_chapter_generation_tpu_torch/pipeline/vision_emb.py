"""Vision-embedding extraction (counterpart of the JAX package's
pipeline/vision_emb.py, convert2vision_emb.py:52-215 of the reference).

Runs the TSM vision backbone over every clip and yields [T, 2048]
embeddings per clip, in memory or written in the reference's npy layout
(<out_dir>/<vid>/vision_emb_<start>_<end>.npy), which
data/datasets.py:npy_vision_emb_provider serves to the title model.
"""

from __future__ import annotations

import os
from typing import Callable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.metrics import StepTimer
from ..data.clip_grid import ClipInfo
from ..data.frames import load_clip_frames
from ..ops.preprocess import normalize_frames


def make_vision_embed_fn(vision_model, device: torch.device) -> Callable:
    """uint8 clips [B, T, ...] (numpy) -> embeddings [B, T, 2048] float32
    on the host, from a models.resnet.Resnet50TSM in eval on `device`
    (JAX :21-44). With the s2d stem the input is the raw 4x4
    space-to-depth pack [B, T, H/4, W/4, 48], which the stem kernel K1
    normalizes; otherwise frames [B, T, H, W, 3], normalized on the device
    to the trunk's dtype (K6) first."""
    trunk = vision_model.base_model
    s2d = trunk.stem_input == "s2d"

    def fn(img_u8: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(img_u8)).to(device)
        if not s2d:
            x = normalize_frames(x, trunk.dtype)
        return vision_model(x).float().cpu().numpy()

    return fn


def extract_vision_embs(
    clips: Sequence[ClipInfo],
    embed_fn: Callable,
    batch_size: int = 16,
    hw: int = 224,
    out_dir: Optional[str] = None,
    timer: Optional[StepTimer] = None,
    s2d: bool = False,
) -> Iterator[Tuple[ClipInfo, np.ndarray]]:
    """Yields (clip, emb [T, 2048] float32) in clip order, batch_size clips
    a call, and writes each to out_dir when given (JAX :47-75). s2d=True
    loads the frames as the s2d pack (pair with an embed_fn of an s2d
    model). The timer counts clips under "host_load" and frames under
    "embed". The JAX function pads the last batch to batch_size for XLA's
    static shapes; here it runs as it is (every clip's embedding depends
    on its own frames only)."""
    timer = timer or StepTimer()
    for start in range(0, len(clips), batch_size):
        rows = clips[start:start + batch_size]
        timer.start("host_load")
        imgs = np.stack([load_clip_frames(c.image_paths, hw, s2d=s2d)
                         for c in rows])
        timer.stop("host_load", len(rows))
        timer.start("embed")
        embs = embed_fn(imgs)
        timer.stop("embed", len(rows) * imgs.shape[1])
        for c, e in zip(rows, embs):
            if out_dir is not None:
                d = os.path.join(out_dir, c.vid)
                os.makedirs(d, exist_ok=True)
                s, t = c.clip_start_end
                np.save(os.path.join(d, f"vision_emb_{s}_{t}.npy"), e)
            yield c, e
