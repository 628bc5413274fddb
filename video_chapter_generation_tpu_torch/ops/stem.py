"""ResNet stems (kernels K1 and K8), all in csrc/stem_s2d.cu.

- `stem_s2d` replaces the JAX package's ops/stem_pallas.py:stem_s2d_pallas
  (K1): uint8 4x4 space-to-depth frames -> normalize, 7x7/2 conv, folded
  BN, ReLU, 3x3/2 max pool. Its conv launch rounds the conv output to
  bf16, and the pool launch of `bn_relu_maxpool` applies BN and ReLU;
- `stem_frames` replaces stem_pallas.py:stem_conv_bn_pool_pallas (K8):
  the same stem on normalized NHWC frames. Its conv launch rounds the
  conv output to bf16 and hands it to `bn_relu_maxpool`;
- `bn_relu_maxpool` replaces stem_pallas.py:bn_relu_maxpool_pallas (K8):
  folded BN + ReLU + 3x3/2 max pool (pad 1) on any NHWC activation.

Each has a plain version (`*_reference`). A CPU tensor takes the plain
version; a CUDA tensor launches the kernel, and any other device raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build
from .preprocess import (
    depth_to_space4,
    norm_consts,
    normalize_frames_reference,
)


def bn_relu_maxpool_reference(x: torch.Tensor, scale: torch.Tensor,
                              bias: torch.Tensor) -> torch.Tensor:
    """Plain version (stem_pallas.py:429): relu(x * scale + bias) in float32
    (or x's wider type), rounded to x.dtype, then the 3x3/2 max pool with
    pad 1 (torch semantics); x [N, H, W, C] -> [N, (H+1)//2, (W+1)//2, C]."""
    dt = x.dtype
    y = torch.relu(x * scale.float() + bias.float()).to(dt)
    y = F.max_pool2d(y.permute(0, 3, 1, 2), 3, stride=2, padding=1)
    return y.permute(0, 2, 3, 1).contiguous()


def _conv7(x_nhwc, w7):
    """The stem's 7x7/2 conv (pad 3) in x's dtype, NHWC -> NHWC."""
    y = F.conv2d(x_nhwc.permute(0, 3, 1, 2),
                 w7.permute(3, 2, 0, 1).to(x_nhwc.dtype), stride=2, padding=3)
    return y.permute(0, 2, 3, 1)


def _conv_stem(x_nhwc, w7, scale, bias):
    """7x7/2 conv (pad 3) + folded BN + ReLU + 3x3/2 max pool (pad 1) on
    normalized NHWC frames; w7 [7, 7, 3, 64] HWIO."""
    return bn_relu_maxpool_reference(_conv7(x_nhwc, w7), scale, bias)


def stem_s2d_reference(s4: torch.Tensor, w7: torch.Tensor,
                       scale: torch.Tensor, bias: torch.Tensor,
                       out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain version: unpack s2d -> normalize -> conv stem.
    s4 [N, h, w, 48] uint8 -> [N, h, w, 64] out_dtype."""
    frames = normalize_frames_reference(depth_to_space4(s4), out_dtype)
    return _conv_stem(frames, w7, scale.float(), bias.float())


def stem_frames_reference(frames: torch.Tensor, w7: torch.Tensor,
                          scale: torch.Tensor,
                          bias: torch.Tensor) -> torch.Tensor:
    """Plain version of `stem_frames`: the conv in frames.dtype, then
    bn_relu_maxpool_reference; [N, H, W, 3] -> [N, H/4, W/4, 64]."""
    return _conv_stem(frames, w7, scale.float(), bias.float())


@functools.lru_cache(maxsize=None)
def identity_affine(device: torch.device, n: int = 64):
    """(ones [n], zeros [n]) float32 on device: a conv epilogue's scale
    and bias that store the bare conv sum (exact in fp32); the stem convs
    use n = 64."""
    return (torch.ones(n, device=device), torch.zeros(n, device=device))


_ARGS = {"vcg_stem_s2d": (9, 3), "vcg_stem_frames_conv": (5, 3),
         "vcg_bn_relu_maxpool": (4, 4)}


def _lib(name: str):
    """The C entry `name` of csrc/stem_s2d.cu: (pointers, ints), stream."""
    fn = getattr(_build.load("stem_s2d"), name)
    if fn.argtypes is None:
        n_ptr, n_int = _ARGS[name]
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _stem_weight(w7: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """HWIO [7, 7, 3, 64] -> bf16 [160, 64], K rows ordered (kh, kw, c) and
    zero-padded 147 -> 160."""
    if tuple(w7.shape) != (7, 7, 3, 64):
        raise ValueError(f"w7 must be [7,7,3,64], got {tuple(w7.shape)}")
    wk = torch.zeros(160, 64, dtype=torch.bfloat16, device=dev)
    wk[:147] = w7.reshape(147, 64).to(device=dev, dtype=torch.bfloat16)
    return wk


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
    dev = s4.device
    wk = _stem_weight(w7, dev)
    scale = scale.to(device=dev, dtype=torch.float32).contiguous()
    bias = bias.to(device=dev, dtype=torch.float32).contiguous()
    norm = norm_consts(dev)
    one, zero = identity_affine(dev)
    conv = torch.empty(n, 2 * h, 2 * w, 64, dtype=torch.bfloat16, device=dev)
    out = torch.empty(n, h, w, 64, dtype=torch.bfloat16, device=dev)
    fn = _lib("vcg_stem_s2d")
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(s4.data_ptr(), wk.data_ptr(), one.data_ptr(), zero.data_ptr(),
            scale.data_ptr(), bias.data_ptr(), norm.data_ptr(),
            conv.data_ptr(), out.data_ptr(), n, h, w, stream)
    stem_s2d.launches += 1
    if rc != 0:
        raise RuntimeError(f"stem_s2d kernel launch failed: CUDA error {rc}")
    return out


def stem_frames(x: torch.Tensor, w7: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """Fused stem on normalized NHWC frames x [N, H, W, 3] (H == W,
    H % 4 == 0) -> [N, H/4, W/4, 64] in x's dtype (the kernel takes bf16).
    w7 [7, 7, 3, 64] (HWIO); scale/bias [64] the inference-folded BN."""
    if x.device.type == "cpu":
        return stem_frames_reference(x, w7, scale, bias)
    if x.device.type != "cuda":
        raise NotImplementedError(f"stem_frames on {x.device}")
    n, h, w, c = x.shape
    if (x.dtype != torch.bfloat16 or c != 3 or h != w or h % 4
            or not x.is_contiguous()):
        raise ValueError(f"stem_frames takes contiguous bf16 [N,H,H,3] with "
                         f"H % 4 == 0, got {x.dtype} {tuple(x.shape)}")
    dev = x.device
    wk = _stem_weight(w7, dev)
    one, zero = identity_affine(dev)
    conv = torch.empty(n, h // 2, w // 2, 64, dtype=torch.bfloat16,
                       device=dev)
    rc = _lib("vcg_stem_frames_conv")(
        x.data_ptr(), wk.data_ptr(), one.data_ptr(), zero.data_ptr(),
        conv.data_ptr(), n, h, w, torch.cuda.current_stream(dev).cuda_stream)
    stem_frames.launches += 1
    if rc != 0:
        raise RuntimeError(f"stem_frames kernel launch failed: CUDA error "
                           f"{rc}")
    return bn_relu_maxpool(conv, scale, bias)


def bn_relu_maxpool(x: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """relu(x * scale + bias) -> 3x3/2 max pool (pad 1): x [N, H, W, C]
    with H and W even -> [N, H/2, W/2, C]; scale/bias [C] (folded BN).
    The kernel takes bf16 with C % 8 == 0."""
    if x.device.type == "cpu":
        return bn_relu_maxpool_reference(x, scale, bias)
    if x.device.type != "cuda":
        raise NotImplementedError(f"bn_relu_maxpool on {x.device}")
    n, h, w, c = x.shape
    if (x.dtype != torch.bfloat16 or c % 8 or h % 2 or w % 2
            or not x.is_contiguous()):
        raise ValueError(f"bn_relu_maxpool takes contiguous bf16 [N,H,W,C] "
                         f"with H, W even and C % 8 == 0, got {x.dtype} "
                         f"{tuple(x.shape)}")
    dev = x.device
    scale = scale.to(device=dev, dtype=torch.float32).contiguous()
    bias = bias.to(device=dev, dtype=torch.float32).contiguous()
    out = torch.empty(n, h // 2, w // 2, c, dtype=torch.bfloat16, device=dev)
    rc = _lib("vcg_bn_relu_maxpool")(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(), n, h,
        w, c, torch.cuda.current_stream(dev).cuda_stream)
    bn_relu_maxpool.launches += 1
    if rc != 0:
        raise RuntimeError(f"bn_relu_maxpool kernel launch failed: CUDA "
                           f"error {rc}")
    return out


stem_s2d.launches = 0
stem_frames.launches = 0
bn_relu_maxpool.launches = 0
