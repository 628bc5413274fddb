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
backward one C call each: `stem_train_fwd`, `stem_train_bwd`; under a
moment group, parallel/dist.py, two each, split at the BN moments, which
the wrapper reduces over the group in between), on the
uint8 cells or, for float input, on bf16 frames read as their cells in
place (a frame wider than 64 cells in column chunks of K1's walk, whose
neighbourhoods read the real cells across a chunk seam). The kernel
keeps the conv output in
the TPU kernel's phase-packed form [cells, 256]: its forward product is
the phase-packed stem of K1 (csrc/stem_tiles.cuh) with a store-and-
moments epilogue, its weight gradient the phase-packed dw2 = z^T du on
the wgmma mainloop, folded back to [7, 7, 3, 64] on the device
(tests/test_torch_stem_train_phase.py holds this decomposition in plain
torch to the plain version and to the JAX kernel).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..parallel import dist
from . import _build, _calls
from .preprocess import (
    depth_to_space4,
    norm_consts,
    normalize_frames_reference,
)
from .stem import _phase_weight, walk_bands
from .tsm_block_train import bn_train, run_phases


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


def _fn(name: str, n_ptr_head: int, n_ptr_tail: int, n_int: int):
    fn = getattr(_build.load("stem_train"), name)
    if fn.argtypes is None:
        # (pointers..., int u8, pointers..., ints..., float eps, int from,
        # int to, double count_scale, stream)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr_head + [ctypes.c_int]
                       + [ctypes.c_void_p] * n_ptr_tail
                       + [ctypes.c_int] * n_int
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_double, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _workspace_floats(n: int, hs: int, ws: int, bands: int) -> int:
    """Floats of the scratch of partial sums (vcg_stem_train_workspace)."""
    fn = _build.load("stem_train").vcg_stem_train_workspace
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 4
        fn.restype = ctypes.c_longlong
    return max(int(fn(n, hs, ws, bands)), 1)


def _workspace(device, n: int, hs: int, ws: int,
               bands: int) -> torch.Tensor:
    return torch.empty(_workspace_floats(n, hs, ws, bands),
                       dtype=torch.float32, device=device)


def _stem_weight(w7: torch.Tensor) -> torch.Tensor:
    """[7, 7, 3, 64] HWIO -> the kernel's bf16 [448, 256]: the phase-packed
    im2col weight (ops/stem.py), K zero-padded 432 -> 448."""
    return _phase_weight(w7, w7.device)


def _kernel_input(s4: torch.Tensor) -> torch.Tensor:
    """What the kernel reads: uint8 cells [N, hs, ws, 48] as they are;
    float cells (depth_to_space4'd) and frames [N, H, W, 3] as contiguous
    bf16 frames, whose 4x4 cells the kernel reads in place. An input that
    does not start on 16 bytes is copied (the kernel loads 16 bytes at a
    time)."""
    if s4.dtype == torch.uint8:
        x = s4.contiguous()
    else:
        x = depth_to_space4(s4) if s4.shape[-1] == 48 else s4
        x = x.to(torch.bfloat16).contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def _cells(x: torch.Tensor):
    """(n, hs, ws) of a kernel input."""
    n, h, w = x.shape[:3]
    return (n, h, w) if x.dtype == torch.uint8 else (n, h // 4, w // 4)


def stem_train_fwd(s4, wk, gb, eps: float):
    """One call of vcg_stem_train_fwd (the product with its moments, the
    statistics, the pool) -> (out, yc [cells, 256] phase-packed, stats
    [2, 64], vec [2, 64])."""
    x = _kernel_input(s4)
    n, hs, ws = _cells(x)
    dev, bf = x.device, torch.bfloat16
    bands = walk_bands(dev, n, hs, ws, halo=False)
    yc = torch.empty(n * hs * ws, 256, dtype=bf, device=dev)
    out = torch.empty(n, hs, ws, 64, dtype=bf, device=dev)
    stats, vec = torch.empty(2, 2, 64, dtype=torch.float32,
                             device=dev).unbind(0)
    part = _workspace(dev, n, hs, ws, bands)
    mg = dist.moment_group()
    # under a moment group the moments, left in stats between the two
    # phases, are summed over the group
    rc = run_phases(
        _fn("vcg_stem_train_fwd", 1, 8, 4), dev,
        (x.data_ptr(), int(x.dtype == torch.uint8), wk.data_ptr(),
         gb.data_ptr(), norm_consts(dev).data_ptr(), yc.data_ptr(),
         out.data_ptr(), stats.data_ptr(), vec.data_ptr(), part.data_ptr(),
         n, hs, ws, bands, eps), 2, lambda i: mg.sum_(stats),
        mg and mg.count_scales(n)[0])
    _calls.count(stem_train_fwd)
    if rc != 0:
        raise RuntimeError(f"stem_train_fwd kernel failed: CUDA error {rc}")
    return out, yc, stats, vec


def stem_train_bwd(dpool, out, yc, s4, gb, stats, vec, eps: float):
    """One call of vcg_stem_train_bwd (the route with its moments, the BN
    backward vectors, the weight gradient, its fold) -> (dw [147, 64],
    dgb [2, 64]), float32."""
    x = _kernel_input(s4)
    n, hs, ws = _cells(x)
    dev = x.device
    dpool = dpool.to(torch.bfloat16).contiguous()
    da = torch.empty_like(yc)
    # dw [147, 64], dgb [2, 64] and the BN vectors abc [192], one buffer
    small = torch.empty(147 * 64 + 128 + 192, dtype=torch.float32,
                        device=dev)
    dw = small[:147 * 64].view(147, 64)
    dgb = small[147 * 64:147 * 64 + 128].view(2, 64)
    abc = small[147 * 64 + 128:]
    part = _workspace(dev, n, hs, ws, 1)
    mg = dist.moment_group()
    # under a moment group the backward moments, left in dgb between the
    # phases, are averaged over the group (parallel/dist.py:MomentGroup)
    rc = run_phases(
        _fn("vcg_stem_train_bwd", 4, 9, 3), dev,
        (dpool.data_ptr(), out.data_ptr(), yc.data_ptr(), x.data_ptr(),
         int(x.dtype == torch.uint8), norm_consts(dev).data_ptr(),
         gb.data_ptr(), stats.data_ptr(), vec.data_ptr(), da.data_ptr(),
         dw.data_ptr(), dgb.data_ptr(), abc.data_ptr(), part.data_ptr(), n,
         hs, ws, eps), 2, lambda i: mg.mean_(dgb),
        mg and mg.count_scales(n)[1])
    _calls.count(stem_train_bwd)
    if rc != 0:
        raise RuntimeError(f"stem_train_bwd kernel failed: CUDA error {rc}")
    return dw, dgb


stem_train_fwd.launches = 0
stem_train_bwd.launches = 0


class _StemTrain(torch.autograd.Function):
    """x: the kernel's input (`_kernel_input`)."""

    @staticmethod
    def forward(ctx, x, w7, gamma, beta, eps):
        gb = torch.cat([gamma.reshape(-1).float(),
                        beta.reshape(-1).float()]).contiguous()
        out, yc, stats, vec = stem_train_fwd(x, _stem_weight(w7), gb, eps)
        ctx.save_for_backward(x, out, yc, gb, stats, vec)
        ctx.eps = eps
        ctx.dtypes = (w7.dtype, gamma.dtype, beta.dtype)
        mu, var = stats.unbind(0)
        ctx.mark_non_differentiable(mu, var)
        return out, mu, var

    @staticmethod
    def backward(ctx, dout, _dmu, _dvar):
        x, out, yc, gb, stats, vec = ctx.saved_tensors
        dw, dgb = stem_train_bwd(dout, out, yc, x, gb, stats, vec, ctx.eps)
        wdt, gdt, bdt = ctx.dtypes
        dw7 = dw.reshape(7, 7, 3, 64).to(wdt)
        return None, dw7, dgb[0].to(gdt), dgb[1].to(bdt), None


def _kernel_stem(x: torch.Tensor, w7, gamma, beta, eps: float,
                 out_dtype: torch.dtype, entry: str):
    """The training stem kernel on a CUDA tensor (uint8 cells, float cells
    or frames) -> (out, (mu, var))."""
    if x.device.type != "cuda":
        raise NotImplementedError(f"{entry} on {x.device}")
    if out_dtype != torch.bfloat16:
        raise ValueError("the training stem kernel emits bfloat16")
    out, mu, var = _StemTrain.apply(_kernel_input(x), w7, gamma, beta, eps)
    return out, (mu, var)


def stem_s2d_train(s4: torch.Tensor, w7: torch.Tensor, gamma, beta,
                   eps: float = 1e-5, out_dtype: torch.dtype = torch.bfloat16):
    """Training stem on [N, H/4, W/4, 48] (uint8 raw pixels, or float
    normalized values) -> (out [N, H/4, W/4, 64] out_dtype, (mu, var))."""
    if s4.dim() != 4 or s4.shape[-1] != 48:
        raise ValueError(f"s2d input must be [N, h, w, 48], got "
                         f"{tuple(s4.shape)}")
    if s4.device.type == "cpu":
        frames = depth_to_space4(s4)
        frames = (normalize_frames_reference(frames, out_dtype)
                  if s4.dtype == torch.uint8 else frames.to(out_dtype))
        return stem_train_reference(frames, w7, gamma, beta, eps)
    return _kernel_stem(s4, w7, gamma, beta, eps, out_dtype, "stem_s2d_train")


def stem_frames_train(x: torch.Tensor, w7: torch.Tensor, gamma, beta,
                      eps: float = 1e-5,
                      out_dtype: torch.dtype = torch.bfloat16):
    """Training stem on normalized frames [N, H, W, 3] (H, W multiples of
    4): on the CPU the s2d view (a reshape), then stem_s2d_train; on the
    card the kernel reads the frames' cells in place."""
    nt, h, w, c = x.shape
    if c != 3 or h % 4 or w % 4:
        raise ValueError(f"frames must be [N, 4h, 4w, 3], got {tuple(x.shape)}")
    if x.device.type != "cpu":
        return _kernel_stem(x, w7, gamma, beta, eps, out_dtype,
                            "stem_frames_train")
    s4 = x.reshape(nt, h // 4, 4, w // 4, 4, 3).permute(0, 1, 3, 2, 4, 5)
    return stem_s2d_train(s4.reshape(nt, h // 4, w // 4, 48).to(out_dtype),
                          w7, gamma, beta, eps, out_dtype)
