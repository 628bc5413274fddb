"""Training-mode ResNet stem with batch-statistics BatchNorm (kernel K11).

Counterpart of the JAX package's ops/stem_train_pallas.py:
`stem_s2d_train` (:329) on the 4x4 space-to-depth input [N, H/4, W/4, 48]
(raw uint8 pixels, normalized inside, or float values) and
`stem_frames_train` (:359) on frames [N, H, W, 3] (a reshape into the
s2d view, then the same function):

    yc  = conv7x7/2(x) (pad 3)          batch-stat BN over all conv pixels
    out = maxpool3x3/2(relu(bn(yc)))    (pad 1)

Returns (out, (mu, var)). The input is data: no input gradient, only
dw7, dgamma, dbeta. The max pool's backward sends a window's gradient to
every position equal to the window max (ties each receive it), as the
TPU kernel does (stem_train_pallas.py:17-24); the plain version here
routes the same way.

A CPU tensor takes the plain version (`stem_train_reference`); a CUDA
tensor runs csrc/stem_train.cu through `_StemTrain` (forward and
backward one C call each: `stem_train_fwd`, `stem_train_bwd`).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .preprocess import depth_to_space4, normalize_frames
from .stem import _norm_consts
from .tsm_block_train import bn_train


def maxpool_ties(y: torch.Tensor) -> torch.Tensor:
    """3x3/2 max pool (pad 1) over NCHW y >= 0 whose gradient reaches every
    window position equal to the window's max. (y is post-ReLU, so the
    zero padding of unfold never exceeds a real value.)"""
    n, c, h, w = y.shape
    pooled = F.max_pool2d(y.detach(), 3, stride=2, padding=1)
    hp, wp = pooled.shape[-2:]
    patches = F.unfold(y, 3, padding=1, stride=2).view(n, c, 9, hp * wp)
    mask = patches.detach() == pooled.reshape(n, c, 1, hp * wp)
    routed = ((patches - patches.detach()) * mask).sum(2)
    return pooled + routed.view(n, c, hp, wp)


def stem_train_reference(frames: torch.Tensor, w7: torch.Tensor, gamma,
                         beta, eps: float = 1e-5):
    """Plain version on normalized frames [N, H, W, 3] (their dtype is the
    compute dtype) -> (out [N, H/4, W/4, 64], (mu, var))."""
    dt = frames.dtype
    yc = F.conv2d(frames.permute(0, 3, 1, 2), w7.permute(3, 2, 0, 1).to(dt),
                  stride=2, padding=3)
    a, mu, var = bn_train(yc, gamma, beta, eps, dims=(0, 2, 3))
    out = maxpool_ties(torch.relu(a))
    return out.permute(0, 2, 3, 1).contiguous(), (mu, var)


def _fn(name: str, n_ptr_head: int, n_ptr_tail: int):
    fn = getattr(_build.load("stem_train"), name)
    if fn.argtypes is None:
        # (pointers..., int u8, pointers..., int n, hs, ws, float eps, stream)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr_head + [ctypes.c_int]
                       + [ctypes.c_void_p] * n_ptr_tail
                       + [ctypes.c_int] * 3 + [ctypes.c_float,
                                               ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _workspace(device, n: int, h: int, w: int) -> torch.Tensor:
    """The float32 scratch of partial sums (vcg_stem_train_workspace)."""
    fn = _build.load("stem_train").vcg_stem_train_workspace
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 3
        fn.restype = ctypes.c_longlong
    return torch.empty(max(int(fn(n, h, w)), 1), dtype=torch.float32,
                       device=device)


def _stem_weight(w7: torch.Tensor) -> torch.Tensor:
    """[7, 7, 3, 64] HWIO -> [160, 64] bf16, rows (kh, kw, c), zero padded."""
    wk = torch.zeros(160, 64, dtype=torch.bfloat16, device=w7.device)
    wk[:147] = w7.reshape(147, 64).to(torch.bfloat16)
    return wk


def stem_train_fwd(s4, wk, gb, eps: float):
    """One launch of vcg_stem_train_fwd -> (out, yc, stats [2, 64], vec)."""
    n, h, w, _ = s4.shape
    dev, bf = s4.device, torch.bfloat16
    yc = torch.empty(n, 2 * h, 2 * w, 64, dtype=bf, device=dev)
    out = torch.empty(n, h, w, 64, dtype=bf, device=dev)
    stats, vec = torch.empty(2, 2, 64, dtype=torch.float32,
                             device=dev).unbind(0)
    mom = torch.empty(128, dtype=torch.float32, device=dev)
    part = _workspace(dev, n, h, w)
    rc = _fn("vcg_stem_train_fwd", 1, 9)(
        s4.data_ptr(), int(s4.dtype == torch.uint8), wk.data_ptr(),
        gb.data_ptr(), _norm_consts(dev).data_ptr(), yc.data_ptr(),
        out.data_ptr(), stats.data_ptr(), vec.data_ptr(), mom.data_ptr(),
        part.data_ptr(), n, h, w, eps,
        torch.cuda.current_stream(dev).cuda_stream)
    stem_train_fwd.launches += 1
    if rc != 0:
        raise RuntimeError(f"stem_train_fwd kernel failed: CUDA error {rc}")
    return out, yc, stats, vec


def stem_train_bwd(dpool, out, yc, s4, gb, stats, vec, eps: float):
    """One launch of vcg_stem_train_bwd -> (dw [160, 64], dgb [2, 64]),
    float32."""
    n, h, w, _ = s4.shape
    dev = s4.device
    dpool = dpool.to(torch.bfloat16).contiguous()
    da = torch.empty_like(yc)
    dw = torch.empty(160, 64, dtype=torch.float32, device=dev)
    dgb = torch.empty(2, 64, dtype=torch.float32, device=dev)
    work = torch.empty(128 + 192, dtype=torch.float32, device=dev)
    part = _workspace(dev, n, h, w)
    rc = _fn("vcg_stem_train_bwd", 4, 9)(
        dpool.data_ptr(), out.data_ptr(), yc.data_ptr(), s4.data_ptr(),
        int(s4.dtype == torch.uint8), _norm_consts(dev).data_ptr(),
        gb.data_ptr(), stats.data_ptr(), vec.data_ptr(), da.data_ptr(),
        dw.data_ptr(), dgb.data_ptr(), work.data_ptr(), part.data_ptr(), n, h,
        w, eps, torch.cuda.current_stream(dev).cuda_stream)
    stem_train_bwd.launches += 1
    if rc != 0:
        raise RuntimeError(f"stem_train_bwd kernel failed: CUDA error {rc}")
    return dw, dgb


stem_train_fwd.launches = 0
stem_train_bwd.launches = 0


class _StemTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, s4, w7, gamma, beta, eps):
        gb = torch.cat([gamma.reshape(-1).float(),
                        beta.reshape(-1).float()]).contiguous()
        out, yc, stats, vec = stem_train_fwd(s4, _stem_weight(w7), gb, eps)
        ctx.save_for_backward(s4, out, yc, gb, stats, vec)
        ctx.eps = eps
        ctx.dtypes = (w7.dtype, gamma.dtype, beta.dtype)
        mu, var = stats.unbind(0)
        ctx.mark_non_differentiable(mu, var)
        return out, mu, var

    @staticmethod
    def backward(ctx, dout, _dmu, _dvar):
        s4, out, yc, gb, stats, vec = ctx.saved_tensors
        dw, dgb = stem_train_bwd(dout, out, yc, s4, gb, stats, vec, ctx.eps)
        wdt, gdt, bdt = ctx.dtypes
        dw7 = dw[:147].reshape(7, 7, 3, 64).to(wdt)
        return None, dw7, dgb[0].to(gdt), dgb[1].to(bdt), None


def stem_s2d_train(s4: torch.Tensor, w7: torch.Tensor, gamma, beta,
                   eps: float = 1e-5, out_dtype: torch.dtype = torch.bfloat16):
    """Training stem on [N, H/4, W/4, 48] (uint8 raw pixels, or float
    normalized values) -> (out [N, H/4, W/4, 64] out_dtype, (mu, var))."""
    if s4.dim() != 4 or s4.shape[-1] != 48:
        raise ValueError(f"s2d input must be [N, h, w, 48], got "
                         f"{tuple(s4.shape)}")
    if s4.device.type == "cpu":
        frames = depth_to_space4(s4)
        frames = (normalize_frames(frames, out_dtype)
                  if s4.dtype == torch.uint8 else frames.to(out_dtype))
        return stem_train_reference(frames, w7, gamma, beta, eps)
    if s4.device.type != "cuda":
        raise NotImplementedError(f"stem_s2d_train on {s4.device}")
    if out_dtype != torch.bfloat16:
        raise ValueError("the training stem kernel emits bfloat16")
    if s4.dtype != torch.uint8:
        s4 = s4.to(torch.bfloat16)
    out, mu, var = _StemTrain.apply(s4.contiguous(), w7, gamma, beta, eps)
    return out, (mu, var)


def stem_frames_train(x: torch.Tensor, w7: torch.Tensor, gamma, beta,
                      eps: float = 1e-5,
                      out_dtype: torch.dtype = torch.bfloat16):
    """Training stem on normalized frames [N, H, W, 3] (H, W multiples of
    4): the s2d view (a reshape), then stem_s2d_train."""
    nt, h, w, c = x.shape
    if c != 3 or h % 4 or w % 4:
        raise ValueError(f"frames must be [N, 4h, 4w, 3], got {tuple(x.shape)}")
    s4 = x.reshape(nt, h // 4, 4, w // 4, 4, 3).permute(0, 1, 3, 2, 4, 5)
    return stem_s2d_train(s4.reshape(nt, h // 4, w // 4, 48).to(out_dtype),
                          w7, gamma, beta, eps, out_dtype)
