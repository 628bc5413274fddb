"""Frame preprocessing: uint8 -> ImageNet-normalized float (kernel K6),
and the 4x4 space-to-depth unpack (counterpart of the JAX package's
ops/preprocess.py and the s2d unpack in models/resnet.py; the host packs
frames with data/native_loader.py:space_to_depth4).

`normalize_frames` replaces ops/preprocess.py:normalize_frames_pallas: a
CPU tensor takes `normalize_frames_reference`, a CUDA tensor runs
csrc/frame_ops.cu (vectors of 8 elements a thread for bf16 out, 4 for
float32; any element count and input alignment; the same multiply and
add roundings, so bit for bit the plain version)."""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from . import _build, _calls

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


@functools.lru_cache(maxsize=None)
def norm_consts(device: torch.device) -> torch.Tensor:
    """[a0, a1, a2, b0, b1, b2] float32 on device, normalized = u8 * a + b;
    made once per device (a host copy per call would stall the stream)."""
    return torch.cat(affine_consts(device)).contiguous()


def normalize_frames_reference(frames_u8: torch.Tensor,
                               out_dtype: torch.dtype = torch.float32
                               ) -> torch.Tensor:
    """[..., H, W, 3] uint8 -> normalized [..., H, W, 3] float: a multiply
    and an add in float32, then a cast to out_dtype."""
    scale, bias = affine_consts(frames_u8.device)
    return (frames_u8.to(torch.float32) * scale + bias).to(out_dtype)


@functools.lru_cache(maxsize=None)
def _normalize_fn():
    """The C entry vcg_normalize_frames, its signature set once."""
    fn = _build.load("frame_ops").vcg_normalize_frames
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                    ctypes.c_int] + [ctypes.c_float] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


# the six constants as the kernel's float arguments (exact float32 values)
_NORM_ARGS = tuple(float(v) for t in affine_consts() for v in t.tolist())


def normalize_frames(frames_u8: torch.Tensor,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """normalize_frames_reference on a CPU tensor; on a CUDA tensor one
    launch of vcg_normalize_frames (uint8 in, float32 or bf16 out)."""
    if frames_u8.device.type == "cpu":
        return normalize_frames_reference(frames_u8, out_dtype)
    if frames_u8.device.type != "cuda":
        raise NotImplementedError(f"normalize_frames on {frames_u8.device}")
    if frames_u8.dtype != torch.uint8 or frames_u8.shape[-1] != 3:
        raise ValueError(f"the normalize kernel takes uint8 [..., 3], got "
                         f"{frames_u8.dtype} {tuple(frames_u8.shape)}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the normalize kernel emits float32 or bfloat16, "
                         f"not {out_dtype}")
    x = frames_u8.contiguous()
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if x.numel() == 0:
        return out
    rc = _calls.on_device(
        _normalize_fn(), x.device, x.data_ptr(), out.data_ptr(), x.numel(),
        out_dtype == torch.bfloat16, *_NORM_ARGS)
    _calls.count(normalize_frames)
    if rc != 0:
        raise RuntimeError(f"normalize_frames kernel failed: CUDA error {rc}")
    return out


normalize_frames.launches = 0


def depth_to_space4(s4: torch.Tensor) -> torch.Tensor:
    """Undo the 4x4 space-to-depth pack: [N, h, w, 48] -> [N, 4h, 4w, 3].
    Channel order (dy, dx, c): pixel (4I + dy, 4J + dx, c) sits in cell
    (I, J) at channel dy * 12 + dx * 3 + c."""
    n, h, w, c48 = s4.shape
    c = c48 // 16
    y = s4.reshape(n, h, w, 4, 4, c).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(n, 4 * h, 4 * w, c)


def resize_frames(frames: torch.Tensor, height: int, width: int
                  ) -> torch.Tensor:
    """Bilinear resize [..., H, W, C] -> [..., height, width, C] on the
    tensor's device (the JAX package's ops/preprocess.py:100,
    jax.image.resize "bilinear": half-pixel centres, a triangle filter
    widened by the scale where it shrinks, i.e. antialiased)."""
    *lead, h, w, c = frames.shape
    x = frames.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    y = F.interpolate(x, size=(height, width), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1).reshape(*lead, height, width, c)
