"""ResNet stem on uint8 4x4 space-to-depth frames (kernel K1).

`stem_s2d` replaces the JAX package's ops/stem_pallas.py:stem_s2d_pallas
with the CUDA kernel in csrc/stem_s2d.cu (normalize, 7x7/2 conv, folded
BN, ReLU, 3x3/2 max pool); `stem_s2d_reference` is its plain version.
A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build
from .preprocess import affine_consts, depth_to_space4, normalize_frames


def _conv_stem(x_nhwc, w7, scale, bias):
    """7x7/2 conv (pad 3) + folded BN + ReLU + 3x3/2 max pool (pad 1) on
    normalized NHWC frames; w7 [7, 7, 3, 64] HWIO."""
    dt = x_nhwc.dtype
    y = F.conv2d(x_nhwc.permute(0, 3, 1, 2), w7.permute(3, 2, 0, 1).to(dt),
                 stride=2, padding=3)
    y = torch.relu(y * scale[:, None, None] + bias[:, None, None]).to(dt)
    y = F.max_pool2d(y, 3, stride=2, padding=1)
    return y.permute(0, 2, 3, 1).contiguous()


def stem_s2d_reference(s4: torch.Tensor, w7: torch.Tensor,
                       scale: torch.Tensor, bias: torch.Tensor,
                       out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain version: unpack s2d -> normalize -> conv stem.
    s4 [N, h, w, 48] uint8 -> [N, h, w, 64] out_dtype."""
    frames = normalize_frames(depth_to_space4(s4), out_dtype)
    return _conv_stem(frames, w7, scale.float(), bias.float())


def stem_frames_reference(frames: torch.Tensor, w7: torch.Tensor,
                          scale: torch.Tensor,
                          bias: torch.Tensor) -> torch.Tensor:
    """The stem on normalized float frames [N, H, W, 3] (plain only: its
    TPU kernel, stem_pallas.py:stem_conv_bn_pool_pallas, is not ported)."""
    if frames.device.type != "cpu":
        raise NotImplementedError(
            "the float-frames stem kernel is not ported; feed uint8 s2d "
            "frames (stem_input='s2d') on CUDA")
    return _conv_stem(frames, w7, scale.float(), bias.float())


@functools.lru_cache(maxsize=None)
def _norm_consts(device: torch.device) -> torch.Tensor:
    """[a0, a1, a2, b0, b1, b2] float32 on device, normalized = u8 * a + b;
    made once per device (a host copy per call would stall the stream)."""
    return torch.cat(affine_consts(device)).contiguous()


def _lib():
    lib = _build.load("stem_s2d")
    fn = lib.vcg_stem_s2d
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def stem_s2d(s4: torch.Tensor, w7: torch.Tensor, scale: torch.Tensor,
             bias: torch.Tensor,
             out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Fused stem, s4 [N, h, w, 48] uint8 raw pixels -> [N, h, w, 64].

    w7 [7, 7, 3, 64] (HWIO); scale/bias [64] the inference-folded BN."""
    if s4.device.type == "cpu":
        return stem_s2d_reference(s4, w7, scale, bias, out_dtype)
    if s4.device.type != "cuda":
        raise NotImplementedError(f"stem_s2d on {s4.device}")
    n, h, w, c48 = s4.shape
    if s4.dtype != torch.uint8 or c48 != 48 or not s4.is_contiguous():
        raise ValueError(f"stem_s2d takes contiguous uint8 [N,h,w,48], got "
                         f"{s4.dtype} {tuple(s4.shape)}")
    if out_dtype != torch.bfloat16:
        raise ValueError("the stem kernel emits bfloat16")
    if tuple(w7.shape) != (7, 7, 3, 64):
        raise ValueError(f"w7 must be [7,7,3,64], got {tuple(w7.shape)}")
    dev = s4.device
    # K rows ordered (kh, kw, c) = HWIO flattened, zero-padded 147 -> 160
    wk = torch.zeros(160, 64, dtype=torch.bfloat16, device=dev)
    wk[:147] = w7.reshape(147, 64).to(device=dev, dtype=torch.bfloat16)
    scale = scale.to(device=dev, dtype=torch.float32).contiguous()
    bias = bias.to(device=dev, dtype=torch.float32).contiguous()
    norm = _norm_consts(dev)
    conv = torch.empty(n, 2 * h, 2 * w, 64, dtype=torch.bfloat16, device=dev)
    out = torch.empty(n, h, w, 64, dtype=torch.bfloat16, device=dev)
    fn = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(s4.data_ptr(), wk.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            norm.data_ptr(), conv.data_ptr(), out.data_ptr(), n, h, w, stream)
    stem_s2d.launches += 1
    if rc != 0:
        raise RuntimeError(f"stem_s2d kernel launch failed: CUDA error {rc}")
    return out


stem_s2d.launches = 0
