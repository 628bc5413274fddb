"""Temporal shift + 1x1 convolution (kernel K5).

Replaces the JAX package's ops/tsm_conv_pallas.py:

    tsm_conv1x1_bn_relu_pallas (:204)  inference, folded-BN + ReLU epilogue
    tsm_conv1x1_pallas         (:215)  training forward, custom VJP

    y = act(conv1x1(temporal_shift(x), w) * scale + bias)

x [N*T, H, W, C] (frames time-major within clips of T), w [C, F] (or
[1, 1, C, F]), scale/bias [F]. The product sums in at least float32 and
rounds once to x.dtype, after the epilogue. (The JAX kernel casts scale
and bias to x.dtype and applies them to the product already rounded to
bf16, and its correction form rounds x[t+1] - x[t] to bf16: the port
does not, so bf16 results differ from it by rounding; parity is tested
in float32.)

`tsm_conv1x1_reference` is the plain version. A CPU tensor takes it; a
CUDA tensor runs csrc/tsm_conv.cu (bf16, C % 32 == 0, F % 64 == 0 and
fold = C / n_div % 8 == 0, which every ResNet-50 width meets; any other
shape raises). `tsm_conv1x1` is differentiable: on the card an autograd
Function whose forward is the kernel without epilogue and whose backward
is the JAX package's closed form (:224-257),

    dX = shift^T(g @ W^T)        dW = shift(x)^T @ g,

the two products by torch.matmul (XLA in the JAX package) and the two
shifts by K7 (ops/temporal_shift.py).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, _calls
from .temporal_shift import shift_kernel, temporal_shift_reference


def tsm_conv1x1_reference(x, w, n_segment: int, n_div: int = 8, scale=None,
                          bias=None, relu: bool = False) -> torch.Tensor:
    """Plain version: the shifted x times w, in at least float32, then
    `* scale + bias` and the ReLU when given, rounded once to x.dtype."""
    c = x.shape[-1]
    acc = torch.promote_types(x.dtype, torch.float32)
    xs = (temporal_shift_reference(x, n_segment, n_div) if n_segment > 0
          else x)
    y = xs.to(acc) @ w.reshape(c, -1).to(acc)
    if scale is not None:
        y = y * scale.to(acc) + bias.to(acc)
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


@functools.lru_cache(maxsize=None)
def identity_affine(device: torch.device, n: int = 64):
    """(ones [n], zeros [n]) float32 on device: a conv epilogue's scale
    and bias that store the bare conv sum (exact in fp32); the stem convs
    use n = 64."""
    return (torch.ones(n, device=device), torch.zeros(n, device=device))


def pair_aligned(v: torch.Tensor) -> torch.Tensor:
    """v, or a contiguous copy where it is not: the kernels' epilogues
    read scale and bias two floats (8 bytes) at a time."""
    if v.is_contiguous() and v.data_ptr() % 8 == 0:
        return v
    return v.clone(memory_format=torch.contiguous_format)


def _launch(x, w, scale, bias, n_segment: int, n_div: int,
            relu: bool) -> torch.Tensor:
    """One launch of vcg_tsm_conv1x1: x bf16 contiguous [N*T, H, W, C], w
    bf16 contiguous [C, F], scale/bias float32 [F] (None: identity)."""
    if x.dim() != 4 or x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError("the shift + 1x1 conv kernel takes contiguous bf16 "
                         f"[N*T, H, W, C], got {x.dtype} {tuple(x.shape)}")
    nt, h, wd, c = x.shape
    f = w.shape[-1]
    if (tuple(w.shape) != (c, f) or w.dtype != torch.bfloat16
            or not w.is_contiguous() or w.device != x.device):
        raise ValueError(f"w must be contiguous bf16 [{c}, F] on {x.device}, "
                         f"got {w.dtype} {tuple(w.shape)}")
    fold = c // n_div if n_segment > 0 else 0
    t = max(n_segment, 1)
    if c % 32 or f % 64 or fold % 8 or nt % t:
        raise ValueError(f"unsupported shape C={c} F={f} fold={fold} "
                         f"N*T={nt} T={n_segment}")
    if scale is None:
        scale, bias = identity_affine(x.device, f)
    for v in (scale, bias):
        if (v.dtype != torch.float32 or v.device != x.device
                or v.numel() != f):
            raise ValueError("scale/bias must be float32 [F] on the device")
    scale, bias = pair_aligned(scale), pair_aligned(bias)
    out = torch.empty(nt, h, wd, f, dtype=torch.bfloat16, device=x.device)
    fn = _build.load("tsm_conv").vcg_tsm_conv1x1
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    rc = _calls.on_device(
        fn, x.device, x.data_ptr(), w.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), out.data_ptr(), nt, h, wd, c, f, t, fold, int(relu))
    if rc != 0:
        raise RuntimeError(f"tsm_conv1x1 kernel failed: CUDA error {rc}")
    return out


def tsm_conv1x1_bn_relu(x, w, scale, bias, n_segment: int,
                        n_div: int = 8) -> torch.Tensor:
    """Inference: relu(conv1x1(shift(x), w) * scale + bias), scale/bias the
    folded BN1 (float32). No gradient."""
    if x.device.type == "cpu":
        return tsm_conv1x1_reference(x, w, n_segment, n_div, scale, bias,
                                     relu=True)
    if x.device.type != "cuda":
        raise NotImplementedError(f"tsm_conv1x1_bn_relu on {x.device}")
    _calls.refuse_grad("tsm_conv1x1_bn_relu", x)
    out = _launch(x, w.reshape(x.shape[-1], -1), scale, bias, n_segment,
                  n_div, relu=True)
    _calls.count(tsm_conv1x1_bn_relu)
    return out


class _TSMConv1x1(torch.autograd.Function):
    """Forward: the kernel on bf16 x and w cast to bf16 here; backward:
    dX and dW by the closed form, dW returned in w's dtype and shape."""

    @staticmethod
    def forward(ctx, x, w, n_segment, n_div):
        c = x.shape[-1]
        x = x.contiguous()
        wk = w.reshape(c, -1).to(torch.bfloat16).contiguous()
        out = _launch(x, wk, None, None, n_segment, n_div, relu=False)
        _calls.count(tsm_conv1x1)
        ctx.save_for_backward(x, wk)
        ctx.args = (n_segment, n_div, w.dtype, w.shape)
        return out

    @staticmethod
    def backward(ctx, g):
        x, wk = ctx.saved_tensors
        n_segment, n_div, w_dtype, w_shape = ctx.args
        c, f = wk.shape
        g = g.to(torch.bfloat16).contiguous()
        gx = (g.reshape(-1, f) @ wk.t()).reshape(x.shape)
        dx = shift_kernel(gx, n_segment, n_div, reverse=True)
        xs = shift_kernel(x, n_segment, n_div)
        dw = xs.reshape(-1, c).t() @ g.reshape(-1, f)
        return dx, dw.to(w_dtype).reshape(w_shape), None, None


def tsm_conv1x1(x, w, n_segment: int, n_div: int = 8) -> torch.Tensor:
    """Training entry: conv1x1(shift(x), w) -> [N*T, H, W, F] in x.dtype,
    differentiable in x and w. On the card x must be bf16; w may be any
    float type (the Function casts it, and its gradient comes back in
    w's type)."""
    if x.device.type == "cpu":
        return tsm_conv1x1_reference(x, w, n_segment, n_div)
    if x.device.type != "cuda":
        raise NotImplementedError(f"tsm_conv1x1 on {x.device}")
    if n_segment <= 0:
        raise ValueError("tsm_conv1x1 shifts in time: n_segment must be > 0")
    return _TSMConv1x1.apply(x, w, n_segment, n_div)


tsm_conv1x1_bn_relu.launches = 0
tsm_conv1x1.launches = 0
