"""Frame preprocessing: uint8 -> ImageNet-normalized float, and the 4x4
space-to-depth unpack (counterpart of the JAX package's ops/preprocess.py
and the s2d unpack in models/resnet.py; the host packs frames with
data/native_loader.py:space_to_depth4)."""

from __future__ import annotations

import numpy as np
import torch

# ImageNet normalization (torchvision convention), as float32 like the JAX
# package, so both compute the affine from the same rounded constants.
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def affine_consts(device=None):
    """(scale [3], bias [3]) float32 with normalized = u8 * scale + bias."""
    scale = 1.0 / (255.0 * IMAGENET_STD)
    bias = -IMAGENET_MEAN / IMAGENET_STD
    return (torch.as_tensor(scale, device=device),
            torch.as_tensor(bias, device=device))


def normalize_frames(frames_u8: torch.Tensor,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[..., H, W, 3] uint8 -> normalized [..., H, W, 3] float: a multiply
    and an add in float32, then a cast to out_dtype."""
    scale, bias = affine_consts(frames_u8.device)
    return (frames_u8.to(torch.float32) * scale + bias).to(out_dtype)


def depth_to_space4(s4: torch.Tensor) -> torch.Tensor:
    """Undo the 4x4 space-to-depth pack: [N, h, w, 48] -> [N, 4h, 4w, 3].
    Channel order (dy, dx, c): pixel (4I + dy, 4J + dx, c) sits in cell
    (I, J) at channel dy * 12 + dx * 3 + c."""
    n, h, w, c48 = s4.shape
    c = c48 // 16
    y = s4.reshape(n, h, w, 4, 4, c).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(n, 4 * h, 4 * w, c)
