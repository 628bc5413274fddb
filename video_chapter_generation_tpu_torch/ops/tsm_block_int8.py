"""W8A8 inference TSM bottlenecks (kernels K9 and K14a).

`tsm_bottleneck_int8` replaces the JAX package's
ops/tsm_block_int8_pallas.py:tsm_bottleneck_int8_pallas with the CUDA
kernel in csrc/tsm_bottleneck_int8.cu: the stride-1 plain bottleneck of
layers 2-4 with int8 weights (per output channel) and int8 activations
(per tensor, calibrated by ops/quantize.py), int32 sums. It is
`quantize_bottleneck` followed by `int8_bottleneck`, the launcher that
the model calls on the blocks it quantized once. Its plain
version is `int8_bottleneck_plain`; `int8_bottleneck_reference` keeps the
JAX function's signature (:679) and returns (out_f32, out_i8).

The integer spec (tsm_block_int8_pallas.py:26-39), as the reference
computes it (dividing by each scale; the TPU kernel multiplies by a
reciprocal, :69-71, which can round a boundary value the other way):

    xq   = x if int8, else clip(round(x / sx))
    y1   = relu(f32(shift(xq) @ w1q) * a1 + b1)
    zcq  = clip(round([y1 left, y1, y1 right] / sz))       (im2col columns)
    d    = f32(zcq @ w2q) * a2,  split into row taps d0, d1, d2
    y2   = relu(((d1 + d0 from the row above) + d2 from the row below) + b2)
    y2q  = clip(round(y2 / sy2))
    out  = relu((f32(y2q @ w3q) * a3 + b3) + xf),  xf = xq * sx or x
    outq = clip(round(out / sout))

with a1 = sx*sw1*s1, a2 = sz*sw2*[s2, s2, s2], a3 = sy2*sw3*s3.

`tsm_bottleneck_s2_planar_int8` (kernel K14a, the same CUDA source)
replaces tsm_block_int8_pallas.py:tsm_bottleneck_s2_planar_int8_pallas:
the stride-2 projection block0 of a quantized stage, whose integer spec
is int8_s2_bottleneck_reference (:609): conv1 as above at full
resolution; conv2 at stride 2 with pad (1, 1), the same per-tap dequant
summed in the order dr 1, 0, 2, then + b2; and

    out  = relu((f32(y2q @ w3q) * a3 + b3) + (f32(xq[::2, ::2] @ wpq) * ap
           + bp)),   ap = sx*swp*sp

with the projection on the same quantized input. It is
`quantize_s2_bottleneck` followed by `int8_s2_bottleneck`; its plain
version is `int8_s2_bottleneck_plain`. Its pair-merged input
[N*T, H, W/2, 2C] is a row-major view of NHWC, so the wrapper views it
back, and the model passes NHWC. Weights
are quantized from the float32 folded parameters (models/resnet.py:447-449
of the JAX package does not cast them first). The integer dots of the
plain version run as float64 matmuls (exact below 2^53; torch has no
int32 matmul on CUDA), so the same code runs on both devices.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from . import _build, _calls
from .temporal_shift import temporal_shift_reference
from .tsm_block import pair_merge


def quantize_weight(w: torch.Tensor):
    """Per-output-channel symmetric int8 (tsm_block_int8_pallas.py:59):
    w [K, N] -> (wq int8 [K, N], sw float32 [N]), sw = max(amax / 127,
    1e-12) over rows, wq = clip(round(w / sw), -127, 127)."""
    wf = w.float()
    sw = torch.clamp(wf.abs().amax(dim=0) / 127.0, min=1e-12)
    wq = torch.clamp(torch.round(wf / sw), -127, 127).to(torch.int8)
    return wq, sw


def _rq(v: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Static requant f32 -> int8: clip(round(v / s)), half to even."""
    return torch.clamp(torch.round(v / s), -127, 127).to(torch.int8)


def _idot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Integer product a [..., K] (int8) x b [K, N] (int8) -> float32, via
    an exact float64 matmul and one rounding to float32 (where int32 ->
    float32 rounds)."""
    return (a.double() @ b.double()).float()


@dataclass
class QuantBottleneck:
    """One block's quantized weights and folded dequant vectors.
    w1q [C, F], w2q [3F, 3F] (rows (dc, c), columns (row tap, out)),
    w3q [F, C] int8 in the JAX layout; w1t, w2t [3, F, 3F], w3t the same
    transposed (K contiguous) for the kernel; a1, b1, a2 [3F], b2, a3, b3
    float32; sc = (sx, sz, sy2, sout) float32 [4] on the device and
    `scalars` the same four as Python floats (the kernel's arguments)."""
    w1q: torch.Tensor
    w2q: torch.Tensor
    w3q: torch.Tensor
    w1t: torch.Tensor
    w2t: torch.Tensor
    w3t: torch.Tensor
    a1: torch.Tensor
    b1: torch.Tensor
    a2: torch.Tensor
    b2: torch.Tensor
    a3: torch.Tensor
    b3: torch.Tensor
    sc: torch.Tensor
    scalars: tuple

    @property
    def f(self) -> int:
        return self.w1q.shape[1]


def quantize_bottleneck(w1, w2, w3, s1, b1, s2, b2, s3, b3,
                        act_scales) -> QuantBottleneck:
    """Quantize one block (tsm_block_int8_pallas.py:475-498): w1 [C, F],
    w2 [3, 3, F, F] HWIO, w3 [F, C] float (cast to float32 first), s*/b*
    the folded BN, act_scales (sx, sz, sy2, sout). Everything lands on
    w1's device."""
    dev = w1.device
    c = w1.shape[0]
    w1 = w1.reshape(c, -1).float()
    f = w1.shape[1]
    w2r = w2.float().reshape(3, 3 * f, f)  # row tap, (dc, c), out
    w2flat = torch.cat([w2r[0], w2r[1], w2r[2]], dim=1)  # [3F, 3F]
    w1q, sw1 = quantize_weight(w1)
    w2q, sw2 = quantize_weight(w2flat)
    w3q, sw3 = quantize_weight(w3.reshape(f, -1))
    sc_host = torch.as_tensor(act_scales).detach().to(
        device="cpu", dtype=torch.float32).reshape(-1)
    sc = sc_host.to(dev)
    sx, sz, sy2 = sc[0], sc[1], sc[2]
    vec = lambda v: v.to(device=dev, dtype=torch.float32).reshape(-1)  # noqa: E731
    s2f = vec(s2)
    return QuantBottleneck(
        w1q=w1q, w2q=w2q, w3q=w3q,
        w1t=w1q.t().contiguous(),
        w2t=w2q.reshape(3 * f, 3, f).permute(1, 2, 0).contiguous(),
        w3t=w3q.t().contiguous(),
        a1=sx * sw1 * vec(s1), b1=vec(b1),
        a2=sz * sw2 * torch.cat([s2f, s2f, s2f]), b2=vec(b2),
        a3=sy2 * sw3 * vec(s3), b3=vec(b3), sc=sc,
        scalars=tuple(sc_host.tolist()))


def int8_bottleneck_plain(x: torch.Tensor, q: QuantBottleneck,
                          n_segment: int, n_div: int = 8):
    """The integer spec on NHWC x [N*T, H, W, C] (int8, or float: the
    stage entry) -> (out float32, out int8), both [N*T, H, W, C]."""
    nt, h, w, c = x.shape
    f = q.f
    sx, sz, sy2, sout = q.sc[0], q.sc[1], q.sc[2], q.sc[3]
    if x.dtype == torch.int8:
        xq, xf = x, x.float() * sx
    else:
        xq, xf = _rq(x.float(), sx), x.float()
    xs = temporal_shift_reference(xq, n_segment, n_div)
    y1 = torch.relu(_idot(xs, q.w1q) * q.a1 + q.b1)
    # im2col of the 3 column taps, quantized as one tensor
    zl = F.pad(y1, (0, 0, 1, 0))[:, :, :w]
    zr = F.pad(y1, (0, 0, 0, 1))[:, :, 1:]
    zcq = _rq(torch.cat([zl, y1, zr], dim=-1), sz)
    dd = _idot(zcq, q.w2q) * q.a2
    d0, d1, d2 = dd[..., :f], dd[..., f:2 * f], dd[..., 2 * f:]
    top = F.pad(d0, (0, 0, 0, 0, 1, 0))[:, :h]
    bot = F.pad(d2, (0, 0, 0, 0, 0, 1))[:, 1:]
    y2 = torch.relu(d1 + top + bot + q.b2)
    y3 = _idot(_rq(y2, sy2), q.w3q) * q.a3 + q.b3
    out = torch.relu(y3 + xf)
    return out, _rq(out, sout)


def int8_bottleneck_reference(x, w1, w2, w3, s1, b1, s2, b2, s3, b3,
                              act_scales, n_segment: int, n_div: int = 8):
    """tsm_block_int8_pallas.py:679 int8_bottleneck_reference:
    -> (out float32, out int8)."""
    q = quantize_bottleneck(w1, w2, w3, s1, b1, s2, b2, s3, b3, act_scales)
    return int8_bottleneck_plain(x, q, n_segment, n_div)


def _lib():
    fn = _build.load("tsm_bottleneck_int8").vcg_tsm_bottleneck_int8
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_float] * 4
                       + [ctypes.c_int] * 9 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _xq_scratch(x: torch.Tensor):
    """The kernels' int8 copy of a bf16 input (quantized by their first
    launch), or None for an int8 input, which they read as it is."""
    if x.dtype == torch.int8:
        return None
    return torch.empty(x.shape, dtype=torch.int8, device=x.device)


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def tsm_bottleneck_int8(x, w1, w2, w3, s1, b1, s2, b2, s3, b3, act_scales,
                        n_segment: int, n_div: int = 8, out_mode: str = "i8",
                        out_dtype: torch.dtype = torch.bfloat16):
    """W8A8 stride-1 plain bottleneck, x [N*T, H, W, C] int8 (an interior
    block; scale act_scales[0]) or float (the stage entry, quantized in
    the kernel) -> [N*T, H, W, C] int8 (out_mode "i8") or out_dtype
    (out_mode "bf16"). w1/w2/w3 are the float folded weights, s*/b* the
    folded BN: quantize_bottleneck, then int8_bottleneck."""
    q = quantize_bottleneck(w1, w2, w3, s1, b1, s2, b2, s3, b3, act_scales)
    return int8_bottleneck(x, q, n_segment, n_div, out_mode, out_dtype)


def int8_bottleneck(x, q: QuantBottleneck, n_segment: int, n_div: int = 8,
                    out_mode: str = "i8",
                    out_dtype: torch.dtype = torch.bfloat16):
    """tsm_bottleneck_int8 on a block quantized ahead (the model caches
    each block's QuantBottleneck). On a CUDA tensor it launches the kernel
    and counts the launch in tsm_bottleneck_int8.launches. out_mode
    "planar" and "planar_i8" (tsm_block_int8_pallas.py:148, :573-577)
    return the pair-merged view [N*T, H, W/2, 2C] of the "bf16" and "i8"
    results."""
    if out_mode not in ("i8", "bf16", "planar", "planar_i8"):
        raise ValueError(f"out_mode {out_mode!r}: 'i8', 'bf16', 'planar' "
                         f"or 'planar_i8'")
    if out_mode.startswith("planar"):
        out = int8_bottleneck(x, q, n_segment, n_div,
                              "i8" if out_mode == "planar_i8" else "bf16",
                              out_dtype)
        return pair_merge(out)
    if x.device.type == "cpu":
        out, outq = int8_bottleneck_plain(x, q, n_segment, n_div)
        return outq if out_mode == "i8" else out.to(out_dtype)
    if x.device.type != "cuda":
        raise NotImplementedError(f"tsm_bottleneck_int8 on {x.device}")
    _calls.refuse_grad("tsm_bottleneck_int8", x)
    nt, h, w, c = x.shape
    f = q.f
    x_i8 = x.dtype == torch.int8
    if not (x_i8 or x.dtype == torch.bfloat16) or not x.is_contiguous():
        raise ValueError(f"tsm_bottleneck_int8 takes contiguous int8 or "
                         f"bf16 NHWC, got {x.dtype}")
    if out_mode == "bf16" and out_dtype != torch.bfloat16:
        raise ValueError("the int8 kernel emits int8 or bfloat16")
    fold = c // n_div
    if (c % 128 or f % 128 or q.w3q.shape[1] != c or fold % 16
            or n_segment <= 0 or nt % n_segment):
        raise ValueError(f"unsupported widths C={c} F={f} fold={fold} "
                         f"N*T={nt} T={n_segment}")
    for t in (q.w1t, q.w2t, q.w3t, q.a1, q.a2, q.a3):
        if t.device != x.device:
            raise ValueError("quantized weights must be on x's device")
    dev = x.device
    m = nt * h * w
    y1q = torch.empty(m, f, dtype=torch.int8, device=dev)
    y2q = torch.empty(m, f, dtype=torch.int8, device=dev)
    out = torch.empty(nt, h, w, c, device=dev,
                      dtype=torch.int8 if out_mode == "i8" else torch.bfloat16)
    xq = _xq_scratch(x)
    sx, sz, sy2, sout = q.scalars
    rc = _calls.on_device(
        _lib(), dev, x.data_ptr(), _ptr(xq), q.w1t.data_ptr(),
        q.w2t.data_ptr(), q.w3t.data_ptr(),
        q.a1.data_ptr(), q.b1.data_ptr(), q.a2.data_ptr(), q.b2.data_ptr(),
        q.a3.data_ptr(), q.b3.data_ptr(), y1q.data_ptr(), y2q.data_ptr(),
        out.data_ptr(), sx, sz, sy2, sout, nt, h, w, c, f, n_segment, fold,
        int(x_i8), int(out_mode == "i8"))
    _calls.count(tsm_bottleneck_int8)
    if rc != 0:
        raise RuntimeError(f"tsm_bottleneck_int8 kernel failed: CUDA error "
                           f"{rc}")
    return out


tsm_bottleneck_int8.launches = 0


@dataclass
class QuantS2Bottleneck(QuantBottleneck):
    """A stride-2 projection block's QuantBottleneck (w3q [F, Cout]) plus
    the projection: wpq [C, Cout] int8 per output channel, wpt its
    transpose for the kernel, ap = sx*swp*sp and bp float32 [Cout]."""
    wpq: torch.Tensor = None
    wpt: torch.Tensor = None
    ap: torch.Tensor = None
    bp: torch.Tensor = None


def quantize_s2_bottleneck(w1, w2, w3, s1, b1, s2, b2, s3, b3, wp, sp, bp,
                           act_scales) -> QuantS2Bottleneck:
    """quantize_bottleneck, and wp [C, Cout] quantized per output channel
    (tsm_block_int8_pallas.py:371), with its folded BN (sp, bp)."""
    q = quantize_bottleneck(w1, w2, w3, s1, b1, s2, b2, s3, b3, act_scales)
    c = q.w1q.shape[0]
    wpq, swp = quantize_weight(wp.reshape(c, -1).float())
    dev = q.w1q.device
    vec = lambda v: v.to(device=dev, dtype=torch.float32).reshape(-1)  # noqa: E731
    return QuantS2Bottleneck(
        **{k: getattr(q, k) for k in q.__dataclass_fields__},
        wpq=wpq, wpt=wpq.t().contiguous(), ap=q.sc[0] * swp * vec(sp),
        bp=vec(bp))


def int8_s2_bottleneck_plain(x: torch.Tensor, q: QuantS2Bottleneck,
                             n_segment: int, n_div: int = 8):
    """The stride-2 integer spec (tsm_block_int8_pallas.py:609) on NHWC
    x [N*T, H, W, C] (int8, or float: the stage entry), H and W even ->
    (out float32, out int8), both [N*T, H/2, W/2, Cout]."""
    h, w = x.shape[1:3]
    f = q.f
    sx, sz, sy2, sout = q.sc[0], q.sc[1], q.sc[2], q.sc[3]
    xq = x if x.dtype == torch.int8 else _rq(x.float(), sx)
    xs = temporal_shift_reference(xq, n_segment, n_div)
    y1 = torch.relu(_idot(xs, q.w1q) * q.a1 + q.b1)
    ho, wo = h // 2, w // 2
    y1p = F.pad(y1, (0, 0, 1, 1, 1, 1))
    acc = None
    for dr in (1, 0, 2):
        rows = y1p[:, dr: dr + 2 * ho: 2]  # padded rows 2r + dr
        z = torch.cat([rows[:, :, 0: 2 * wo: 2], rows[:, :, 1: 2 * wo + 1: 2],
                       rows[:, :, 2: 2 * wo + 2: 2]], dim=-1)
        d = (_idot(_rq(z, sz), q.w2q[:, dr * f:(dr + 1) * f])
             * q.a2[dr * f:(dr + 1) * f])
        acc = d if acc is None else acc + d
    y2 = torch.relu(acc + q.b2)
    y3 = _idot(_rq(y2, sy2), q.w3q) * q.a3 + q.b3
    res = _idot(xq[:, ::2, ::2], q.wpq) * q.ap + q.bp
    out = torch.relu(y3 + res)
    return out, _rq(out, sout)


def int8_s2_bottleneck_reference(x, w1, w2, w3, s1, b1, s2, b2, s3, b3, wp,
                                 sp, bp, act_scales, n_segment: int,
                                 n_div: int = 8):
    """tsm_block_int8_pallas.py:609 int8_s2_bottleneck_reference on NHWC x:
    -> (out float32, out int8)."""
    q = quantize_s2_bottleneck(w1, w2, w3, s1, b1, s2, b2, s3, b3, wp, sp,
                               bp, act_scales)
    return int8_s2_bottleneck_plain(x, q, n_segment, n_div)


def _s2_lib():
    fn = _build.load("tsm_bottleneck_int8").vcg_tsm_bottleneck_s2_int8
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 17 + [ctypes.c_float] * 4
                       + [ctypes.c_int] * 10 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def tsm_bottleneck_s2_planar_int8(xpm, w1, w2, w3, s1, b1, s2, b2, s3, b3,
                                  wp, sp, bp, act_scales, n_segment: int,
                                  n_div: int = 8, out_mode: str = "i8",
                                  out_dtype: torch.dtype = torch.bfloat16):
    """W8A8 stride-2 projection bottleneck on the pair-merged input
    xpm [N*T, H, W/2, 2C] int8 (inside a stage; scale act_scales[0]) or
    float (the stage entry, quantized in the kernel) -> [N*T, H/2, W/2,
    Cout] int8 (out_mode "i8") or out_dtype (any other out_mode, as the
    JAX function). w1/w2/w3/wp are the float folded weights, s*/b*/sp/bp
    the folded BN: quantize_s2_bottleneck, then int8_s2_bottleneck."""
    nt, h, wh, c2 = xpm.shape
    x = xpm.reshape(nt, h, 2 * wh, c2 // 2)
    q = quantize_s2_bottleneck(w1, w2, w3, s1, b1, s2, b2, s3, b3, wp, sp,
                               bp, act_scales)
    return int8_s2_bottleneck(x, q, n_segment, n_div,
                              "i8" if out_mode == "i8" else "bf16", out_dtype)


def int8_s2_bottleneck(x, q: QuantS2Bottleneck, n_segment: int,
                       n_div: int = 8, out_mode: str = "i8",
                       out_dtype: torch.dtype = torch.bfloat16):
    """The stride-2 block on NHWC x [N*T, H, W, C] (H, W even) with a
    block quantized ahead -> [N*T, H/2, W/2, Cout] int8 ("i8") or
    out_dtype ("bf16"). On a CUDA tensor it launches the K14a kernel and
    counts the launch in tsm_bottleneck_s2_planar_int8.launches."""
    if out_mode not in ("i8", "bf16"):
        raise ValueError(f"out_mode {out_mode!r}: 'i8' or 'bf16'")
    nt, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"the stride-2 int8 block needs an even H and W, "
                         f"got {h}x{w}")
    if x.device.type == "cpu":
        out, outq = int8_s2_bottleneck_plain(x, q, n_segment, n_div)
        return outq if out_mode == "i8" else out.to(out_dtype)
    if x.device.type != "cuda":
        raise NotImplementedError(f"tsm_bottleneck_s2_planar_int8 on "
                                  f"{x.device}")
    _calls.refuse_grad("tsm_bottleneck_s2_planar_int8", x)
    f = q.f
    cout = q.w3q.shape[1]
    x_i8 = x.dtype == torch.int8
    if not (x_i8 or x.dtype == torch.bfloat16) or not x.is_contiguous():
        raise ValueError(f"tsm_bottleneck_s2_planar_int8 takes contiguous "
                         f"int8 or bf16 NHWC, got {x.dtype}")
    if out_mode == "bf16" and out_dtype != torch.bfloat16:
        raise ValueError("the int8 kernel emits int8 or bfloat16")
    fold = c // n_div
    if (c % 128 or f % 128 or cout % 128 or q.w1q.shape[0] != c or fold % 16
            or n_segment <= 0 or nt % n_segment):
        raise ValueError(f"unsupported widths C={c} F={f} Cout={cout} "
                         f"fold={fold} N*T={nt} T={n_segment}")
    for t in (q.w1t, q.w2t, q.w3t, q.wpt, q.a1, q.a2, q.a3, q.ap):
        if t.device != x.device:
            raise ValueError("quantized weights must be on x's device")
    dev = x.device
    ho, wo = h // 2, w // 2
    y1q = torch.empty(nt * h * w, f, dtype=torch.int8, device=dev)
    y2q = torch.empty(nt * ho * wo, f, dtype=torch.int8, device=dev)
    out = torch.empty(nt, ho, wo, cout, device=dev,
                      dtype=torch.int8 if out_mode == "i8" else torch.bfloat16)
    sx, sz, sy2, sout = q.scalars
    xq = _xq_scratch(x)
    rc = _calls.on_device(
        _s2_lib(), dev, x.data_ptr(), _ptr(xq), q.w1t.data_ptr(),
        q.w2t.data_ptr(), q.w3t.data_ptr(),
        q.wpt.data_ptr(), q.a1.data_ptr(), q.b1.data_ptr(), q.a2.data_ptr(),
        q.b2.data_ptr(), q.a3.data_ptr(), q.b3.data_ptr(), q.ap.data_ptr(),
        q.bp.data_ptr(), y1q.data_ptr(), y2q.data_ptr(), out.data_ptr(), sx,
        sz, sy2, sout, nt, h, w, c, f, cout, n_segment, fold, int(x_i8),
        int(out_mode == "i8"))
    _calls.count(tsm_bottleneck_s2_planar_int8)
    if rc != 0:
        raise RuntimeError(f"tsm_bottleneck_s2_planar_int8 kernel failed: "
                           f"CUDA error {rc}")
    return out


tsm_bottleneck_s2_planar_int8.launches = 0
