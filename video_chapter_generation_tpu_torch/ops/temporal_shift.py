"""Temporal Shift Module (kernel K7) and the plain shift + 1x1 conv forms.

With channels split into n_div folds, fold 0 takes frame t + 1, fold 1
takes frame t - 1, the rest pass through; out-of-range frames are zero.
Frames are time-major within each clip (the `(b t)` flattening). The
reverse shift moves the two folds the other way: it is the transpose of
the shift, so the gradient of one is the other.

- `temporal_shift` replaces the JAX package's
  ops/temporal_shift.py:temporal_shift_pallas (K7). A CPU tensor takes
  `temporal_shift_reference` (differentiated by autograd); a CUDA tensor
  runs csrc/frame_ops.cu through an autograd Function whose backward is
  the reverse shift on the same kernel. Any dtype; a copy, so the kernel
  equals its plain version bit for bit. `temporal_shift.launches` counts
  every launch, forward and backward.
- `temporal_shift_conv1x1` (:151) and `temporal_shift_conv1x1_3tap`
  (:191) are the JAX package's XLA forms of shift + 1x1 conv (three
  partial products; one 3-tap convolution with a channel-masked kernel):
  plain torch here, the conv1 of tsm_impl "xla" and "tap3".
- `temporal_pool` (JAX ops/temporal_shift.py:133) is the max over time,
  kernel 3, stride 2, pad 1: plain torch (the JAX package has no kernel
  for it, and no model calls it).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build, _calls


def temporal_shift_reference(x: torch.Tensor, n_segment: int,
                             n_div: int = 8,
                             reverse: bool = False) -> torch.Tensor:
    """x [N*T, H, W, C] (or [B, T, H, W, C]) -> same shape, shifted."""
    squeeze = x.dim() == 4
    if squeeze:
        x = x.reshape(x.shape[0] // n_segment, n_segment, *x.shape[1:])
    fold = x.shape[-1] // n_div
    nxt, prv = (slice(None, fold), slice(fold, 2 * fold))
    if reverse:
        nxt, prv = prv, nxt
    out = torch.zeros_like(x)
    out[:, :-1, ..., nxt] = x[:, 1:, ..., nxt]
    out[:, 1:, ..., prv] = x[:, :-1, ..., prv]
    out[..., 2 * fold:] = x[..., 2 * fold:]
    if squeeze:
        out = out.reshape(-1, *out.shape[2:])
    return out


def _lib():
    fn = _build.load("frame_ops").vcg_temporal_shift
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 2
                       + [ctypes.c_longlong] + [ctypes.c_int] * 4
                       + [ctypes.c_longlong] + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def shift_kernel(x: torch.Tensor, n_segment: int, n_div: int = 8,
                 reverse: bool = False) -> torch.Tensor:
    """One launch of vcg_temporal_shift on a contiguous CUDA x [N*T, ...,
    C] (or [B, T, ..., C]); counted on temporal_shift.launches."""
    if not x.is_contiguous():
        raise ValueError("the shift kernel takes a contiguous tensor")
    c = x.shape[-1]
    nt = x.shape[0] * (x.shape[1] if x.dim() == 5 else 1)
    if n_segment <= 0 or nt % n_segment:
        raise ValueError(f"{nt} frames do not split into clips of "
                         f"{n_segment}")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    es, fold = x.element_size(), c // n_div
    vec = next(v for v in (16, 8, 4, 2, 1)
               if (c * es) % v == 0 and (fold * es) % v == 0
               and x.data_ptr() % v == 0 and out.data_ptr() % v == 0)
    hw = x.numel() // (nt * c)
    rc = _calls.on_device(_lib(), x.device, x.data_ptr(), out.data_ptr(),
                          nt * hw, c, fold, es, vec, hw, n_segment,
                          int(reverse))
    _calls.count(temporal_shift)
    if rc != 0:
        raise RuntimeError(f"temporal_shift kernel failed: CUDA error {rc}")
    return out


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n_segment, n_div, reverse):
        ctx.args = (n_segment, n_div, not reverse)
        return shift_kernel(x.contiguous(), n_segment, n_div, reverse)

    @staticmethod
    def backward(ctx, g):
        return shift_kernel(g.contiguous(), *ctx.args), None, None, None


def temporal_shift(x: torch.Tensor, n_segment: int, n_div: int = 8,
                   reverse: bool = False) -> torch.Tensor:
    """The shift (reverse: its transpose); differentiable in x."""
    if x.device.type == "cpu":
        return temporal_shift_reference(x, n_segment, n_div, reverse)
    if x.device.type != "cuda":
        raise NotImplementedError(f"temporal_shift on {x.device}")
    return _Shift.apply(x, n_segment, n_div, reverse)


temporal_shift.launches = 0


def temporal_shift_conv1x1(x: torch.Tensor, kernel: torch.Tensor,
                           n_segment: int, n_div: int = 8) -> torch.Tensor:
    """conv1x1(temporal_shift(x)) as three partial products on
    time-shifted slices (the JAX package's temporal_shift.py:151): each
    product sums in at least float32 and rounds to x.dtype, then the three
    add in x.dtype. x [N*T, H, W, C]; kernel [C, F] or [1, 1, C, F]."""
    nt, h, w, c = x.shape
    b, f = nt // n_segment, c // n_div
    k = kernel.reshape(c, -1)
    x4 = x.reshape(b, n_segment, h * w, c)
    acc = torch.promote_types(x.dtype, torch.float32)

    def dot(xs, ks):
        return (xs.to(acc) @ ks.to(acc)).to(x.dtype)

    y_same = dot(x4[..., 2 * f:], k[2 * f:])
    zpad = torch.zeros_like(y_same[:, :1])
    # fold 0 takes from t + 1: it adds to outputs 0..T-2
    y_left = torch.cat([dot(x4[:, 1:, :, :f], k[:f]), zpad], dim=1)
    # fold 1 takes from t - 1: it adds to outputs 1..T-1
    y_right = torch.cat([zpad, dot(x4[:, :-1, :, f:2 * f], k[f:2 * f])],
                        dim=1)
    return (y_same + y_left + y_right).reshape(nt, h, w, -1)


def temporal_shift_conv1x1_3tap(x: torch.Tensor, kernel: torch.Tensor,
                                n_segment: int,
                                n_div: int = 8) -> torch.Tensor:
    """conv1x1(temporal_shift(x)) as one convolution over [B, T, H*W, C]
    with a size-3 temporal window and zero padding in time (the JAX
    package's temporal_shift.py:191): tap 2 holds W's fold-0 rows (reads
    x[t + 1]), tap 0 the fold-1 rows (x[t - 1]), tap 1 the rest. In
    x.dtype; differentiable in x and kernel."""
    nt, h, w, c = x.shape
    b, fold = nt // n_segment, c // n_div
    k2 = kernel.reshape(c, -1).to(x.dtype)
    zero = torch.zeros_like(k2)
    rows = torch.arange(c, device=x.device)[:, None]
    k3 = torch.stack([torch.where((rows >= fold) & (rows < 2 * fold), k2,
                                  zero),
                      torch.where(rows >= 2 * fold, k2, zero),
                      torch.where(rows < fold, k2, zero)])  # [3, C, F]
    x4 = x.reshape(b, n_segment, h * w, c).permute(0, 3, 1, 2)
    y = F.conv2d(x4, k3.permute(2, 1, 0)[..., None], padding=(1, 0))
    return y.permute(0, 2, 3, 1).reshape(nt, h, w, -1)


def temporal_pool(x: torch.Tensor, n_segment: int) -> torch.Tensor:
    """Max-pool over time, kernel 3, stride 2, pad 1 (JAX
    ops/temporal_shift.py:133): x [N*T, H, W, C] -> [N*To, H, W, C] with
    To = (T - 1) // 2 + 1. The padding is -inf for a float dtype and the
    dtype's minimum for an integer one, so it never wins."""
    nt = x.shape[0]
    x5 = x.reshape(nt // n_segment, n_segment, *x.shape[1:])
    low = (float("-inf") if x.dtype.is_floating_point
           else torch.iinfo(x.dtype).min)
    pad = x5.new_full((x5.shape[0], 1, *x5.shape[2:]), low)
    xp = torch.cat([pad, x5, pad], dim=1)
    t_out = (n_segment - 1) // 2 + 1
    taps = [xp[:, k:k + 2 * t_out - 1:2] for k in range(3)]
    out = torch.maximum(torch.maximum(taps[0], taps[1]), taps[2])
    return out.reshape(-1, *x.shape[1:])
