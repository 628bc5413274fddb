"""Training-mode TSM bottleneck with batch-statistics BatchNorm (kernel K12).

Counterpart of the JAX package's ops/tsm_block_train_pallas.py:

    tsm_bottleneck_train       (:1483)  stride 1, identity residual
    tsm_bottleneck_proj_train  (:1519)  stride 1, 1x1 projection residual
    tsm_bottleneck_s2_train    (:1926)  stride 2 on the 3x3 and the projection

Each returns (y, stats): the block output and the biased batch (mu, var)
of every BatchNorm in float32 (bn1, bn2, bn3[, proj]), eps 1e-5, for the
caller's running-average update; the stats carry no gradient.

    u  = conv1x1(temporal_shift(x))      a1 = bn1(u)   (batch stats)
    z  = conv3x3(relu(a1), stride)       a2 = bn2(z)
    p  = conv1x1(relu(a2))               a3 = bn3(p)
    y  = relu(a3 + x)   or   relu(a3 + bnp(conv1x1(x, stride)))

A CPU tensor takes the plain version (`tsm_block_train_reference`: convs
plus explicit batch-stat BN, differentiated by autograd). A CUDA tensor
runs csrc/conv_train.cu through `_BlockTrain`, a torch.autograd.Function
whose forward and backward are one C call each (`block_train_fwd`,
`block_train_bwd`); there is no fallback to the plain version.

Weights come in the JAX package's layout: w1 [C, F] (or [1, 1, C, F]),
w2 [3, 3, F, F] HWIO, w3 [F, Co], wp [C, Co]; gammas and betas are float32.
The CUDA path casts the weights to bf16 inside the Function, so weight
gradients come back float32 for float32 parameters.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .temporal_shift import temporal_shift


def at_least_f32(v: torch.Tensor) -> torch.Tensor:
    """float32 for half types; float32/float64 stay as they are."""
    return v if v.dtype in (torch.float32, torch.float64) else v.float()


def bn_train(v: torch.Tensor, gamma, beta, eps: float, dims=(0, 1, 2)):
    """Batch-statistics BatchNorm as the JAX package computes it: mean and
    biased variance E[v^2] - mu^2 in at least float32 over `dims`, the
    normalized output cast back to v's dtype. Returns (out, mu, var) with
    the statistics detached (running averages do not backprop)."""
    vf = at_least_f32(v)
    mu = vf.mean(dims)
    var = (vf * vf).mean(dims) - mu * mu
    shape = [1] * v.dim()
    ch = [d for d in range(v.dim()) if d not in dims][0]
    shape[ch] = -1
    out = ((vf - mu.view(shape)) * torch.rsqrt(var.view(shape) + eps)
           * gamma.view(shape) + beta.view(shape)).to(v.dtype)
    return out, mu.detach(), var.detach()


def conv_nhwc(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
              pad: int = 0) -> torch.Tensor:
    """Convolution of NHWC x with an HWIO weight (a 2-d [Cin, Cout] weight
    is a 1x1), in x's dtype."""
    if w.dim() == 2:
        w = w.reshape(1, 1, *w.shape)
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).to(x.dtype),
                 stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1)


def tsm_block_train_reference(x, w1, w2, w3, g1, be1, g2, be2, g3, be3,
                              n_segment: int, n_div: int = 8,
                              eps: float = 1e-5, wp=None, gp=None, bep=None,
                              stride: int = 1):
    """Plain version on NHWC x [N*T, H, W, C] -> (y, stats)."""
    c = x.shape[-1]
    xs = temporal_shift(x, n_segment, n_div) if n_segment > 0 else x
    u = conv_nhwc(xs, w1.reshape(c, -1))
    a1, mu1, v1 = bn_train(u, g1, be1, eps)
    z = conv_nhwc(torch.relu(a1), w2.reshape(3, 3, *w2.shape[-2:]), stride, 1)
    a2, mu2, v2 = bn_train(z, g2, be2, eps)
    p = conv_nhwc(torch.relu(a2), w3.reshape(w3.shape[-2], -1))
    a3, mu3, v3 = bn_train(p, g3, be3, eps)
    if wp is None:
        return torch.relu(a3 + x), (mu1, v1, mu2, v2, mu3, v3)
    pr = conv_nhwc(x, wp.reshape(c, -1), stride)
    ap, mup, vp = bn_train(pr, gp, bep, eps)
    return torch.relu(a3 + ap), (mu1, v1, mu2, v2, mu3, v3, mup, vp)


# ---------------------------------------------------------------------------
# the CUDA kernels (csrc/conv_train.cu)
# ---------------------------------------------------------------------------


def _fn(name: str, n_ptr: int, n_int: int):
    fn = getattr(_build.load("conv_train"), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _workspace(device, nt, h, w, c, f, co, stride) -> torch.Tensor:
    """The float32 scratch of per-block partial sums both entries need
    (their size comes from vcg_block_train_workspace)."""
    fn = _build.load("conv_train").vcg_block_train_workspace
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 7
        fn.restype = ctypes.c_longlong
    n = fn(nt, h, w, c, f, co, stride)
    return torch.empty(max(int(n), 1), dtype=torch.float32, device=device)


def kernel_weights(w1, w2, w3, wp=None):
    """bf16 kernel layouts: forward (w1 [C,F], w2 [9F,F], w3 [F,Co],
    wp [C,Co]) and transposed for the data gradients (w1t [F,C], w2t
    [9F,F] with rows (kh, kw, f), w3t [Co,F], wpt [Co,C])."""
    bf = torch.bfloat16
    f = w2.shape[-1]
    w1 = w1.reshape(-1, f)
    w3 = w3.reshape(f, -1)
    w2 = w2.reshape(3, 3, f, f)
    fwd = [w1.to(bf).contiguous(), w2.reshape(9 * f, f).to(bf).contiguous(),
           w3.to(bf).contiguous(),
           None if wp is None else wp.reshape(w1.shape[0], -1).to(bf)
           .contiguous()]
    bwd = [w1.t().to(bf).contiguous(),
           w2.permute(0, 1, 3, 2).reshape(9 * f, f).to(bf).contiguous(),
           w3.t().to(bf).contiguous(),
           None if wp is None else wp.reshape(w1.shape[0], -1).t().to(bf)
           .contiguous()]
    return fwd, bwd


def pack_affines(f: int, co: int, g1, be1, g2, be2, g3, be3, gp=None,
                 bep=None) -> torch.Tensor:
    """gamma/beta of the block's BNs as one float32 vector in the kernels'
    layout [g1 be1 g2 be2 (F each) g3 be3 gp bep (Co each)]."""
    zero = torch.zeros(co, dtype=torch.float32, device=g1.device)
    parts = [g1, be1, g2, be2, g3, be3,
             zero if gp is None else gp, zero if bep is None else bep]
    return torch.cat([p.reshape(-1).float() for p in parts]).contiguous()


def split_stats(v: torch.Tensor, f: int, co: int, proj: bool):
    """The kernels' [4F + 4Co] layout -> (v1, v1', v2, v2', v3, v3'[, vp,
    vp'])."""
    sizes = [f] * 4 + [co] * 4
    parts = torch.split(v, sizes)
    return tuple(parts[:8] if proj else parts[:6])


def _check(x, f, co, stride, n_segment, n_div, proj):
    nt, h, w, c = x.shape
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError("the training bottleneck kernel takes contiguous "
                         "bf16 NHWC")
    if n_segment <= 0:
        raise ValueError("the training bottleneck kernel shifts in time: "
                         f"n_segment must be > 0, got {n_segment}")
    fold = c // n_div
    if (c % 64 or f % 64 or co % 64 or 256 % (co // 8) or fold % 8
            or nt % n_segment):
        raise ValueError(f"unsupported widths C={c} F={f} Co={co} "
                         f"fold={fold} N*T={nt} T={n_segment}")
    if not proj and (stride != 1 or co != c):
        raise ValueError("an identity residual needs stride 1 and Co == C")
    return nt, h, w, c, fold


def block_train_fwd(x, wf, gb, stride: int, n_segment: int, n_div: int,
                    eps: float):
    """One launch of vcg_block_train_fwd. wf: kernel_weights(...)[0]; gb:
    pack_affines(...). Returns (y, stats, vec, (u, z, p, pr))."""
    w1, w2, w3, wp = wf
    f, co = w1.shape[1], w3.shape[1]
    nt, h, w, c, fold = _check(x, f, co, stride, n_segment, n_div,
                               wp is not None)
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    dev, bf = x.device, torch.bfloat16
    u = torch.empty(nt, h, w, f, dtype=bf, device=dev)
    z = torch.empty(nt, ho, wo, f, dtype=bf, device=dev)
    p = torch.empty(nt, ho, wo, co, dtype=bf, device=dev)
    pr = torch.empty_like(p) if wp is not None else None
    y = torch.empty_like(p)
    n_vec = 4 * f + 4 * co
    stats, vec, mom = torch.empty(3, n_vec, dtype=torch.float32,
                                  device=dev).unbind(0)
    part = _workspace(dev, nt, h, w, c, f, co, stride)
    rc = _fn("vcg_block_train_fwd", 15, 9)(
        x.data_ptr(), w1.data_ptr(), w2.data_ptr(), w3.data_ptr(), _ptr(wp),
        gb.data_ptr(), u.data_ptr(), z.data_ptr(), p.data_ptr(), _ptr(pr),
        y.data_ptr(), stats.data_ptr(), vec.data_ptr(), mom.data_ptr(),
        part.data_ptr(), nt, h, w, c, f, co, stride, n_segment, fold, eps,
        torch.cuda.current_stream(dev).cuda_stream)
    block_train_fwd.launches += 1
    if rc != 0:
        raise RuntimeError(f"block_train_fwd kernel failed: CUDA error {rc}")
    return y, stats, vec, (u, z, p, pr)


def block_train_bwd(dy, x, saved, y, wb, gb, stats, vec, stride: int,
                    n_segment: int, n_div: int, eps: float):
    """One launch of vcg_block_train_bwd. wb: kernel_weights(...)[1].
    Returns (dx bf16, dw1, dw2 [9F, F], dw3, dwp or None, dgb) with the
    weight and affine gradients in float32."""
    u, z, p, pr = saved
    w1t, w2t, w3t, wpt = wb
    f, co = w1t.shape[0], w3t.shape[0]
    nt, h, w, c, fold = _check(x, f, co, stride, n_segment, n_div,
                               wpt is not None)
    dev, bf, f32 = x.device, torch.bfloat16, torch.float32
    dy = dy.to(bf).contiguous()
    dx = torch.empty(nt, h, w, c, dtype=bf, device=dev)
    dw1 = torch.empty(c, f, dtype=f32, device=dev)
    dw2 = torch.empty(9 * f, f, dtype=f32, device=dev)
    dw3 = torch.empty(f, co, dtype=f32, device=dev)
    dwp = torch.empty(c, co, dtype=f32, device=dev) if wpt is not None else None
    dgb = torch.empty(4 * f + 4 * co, dtype=f32, device=dev)
    dq = torch.empty_like(p)
    da2 = torch.empty_like(z)
    da1 = torch.empty_like(u)
    work = torch.empty(9 * co + 10 * f, dtype=f32, device=dev)
    part = _workspace(dev, nt, h, w, c, f, co, stride)
    rc = _fn("vcg_block_train_bwd", 25, 9)(
        dy.data_ptr(), x.data_ptr(), u.data_ptr(), z.data_ptr(), p.data_ptr(),
        _ptr(pr), y.data_ptr(), w1t.data_ptr(), w2t.data_ptr(),
        w3t.data_ptr(), _ptr(wpt), gb.data_ptr(), stats.data_ptr(),
        vec.data_ptr(), dx.data_ptr(), dw1.data_ptr(), dw2.data_ptr(),
        dw3.data_ptr(), _ptr(dwp), dgb.data_ptr(), dq.data_ptr(),
        da2.data_ptr(), da1.data_ptr(), work.data_ptr(), part.data_ptr(),
        nt, h, w, c, f, co, stride, n_segment, fold, eps,
        torch.cuda.current_stream(dev).cuda_stream)
    block_train_bwd.launches += 1
    if rc != 0:
        raise RuntimeError(f"block_train_bwd kernel failed: CUDA error {rc}")
    return dx, dw1, dw2, dw3, dwp, dgb


block_train_fwd.launches = 0
block_train_bwd.launches = 0


class BlockTrainState:
    """What one block's forward keeps for its backward (CUDA path):
    x, y and saved = (u, z, p, pr)."""

    def __init__(self, x, params, stride, n_segment, n_div, eps):
        w1, w2, w3, wp, g1, be1, g2, be2, g3, be3, gp, bep = params
        self.shapes = [t.shape for t in (w1, w2, w3, wp) if t is not None]
        self.wf, self.wb = kernel_weights(w1, w2, w3, wp)
        f, co = self.wf[0].shape[1], self.wf[2].shape[1]
        self.f, self.co, self.proj = f, co, wp is not None
        self.gb = pack_affines(f, co, g1, be1, g2, be2, g3, be3, gp, bep)
        self.stride, self.t, self.n_div, self.eps = (stride, n_segment,
                                                      n_div, eps)
        self.x = x
        self.y, self.stats, self.vec, self.saved = block_train_fwd(
            x, self.wf, self.gb, stride, n_segment, n_div, eps)

    def stats_tuple(self):
        return split_stats(self.stats, self.f, self.co, self.proj)

    def backward(self, dy):
        """-> (dx, grads in the parameter order w1 w2 w3 wp g1 be1 g2 be2
        g3 be3 gp bep; None for an absent projection)."""
        dx, dw1, dw2, dw3, dwp, dgb = block_train_bwd(
            dy, self.x, self.saved, self.y, self.wb, self.gb, self.stats,
            self.vec, self.stride, self.t, self.n_div, self.eps)
        shapes = iter(self.shapes)
        dws = [dw.reshape(next(shapes)) if dw is not None else None
               for dw in (dw1, dw2, dw3, dwp)]
        aff = list(split_stats(dgb, self.f, self.co, True))
        if not self.proj:
            aff[6] = aff[7] = None
        return dx, dws + aff


class _BlockTrain(torch.autograd.Function):
    """One bottleneck on the CUDA kernels; inputs x, then the 12 block
    parameters (w1 w2 w3 wp g1 be1 g2 be2 g3 be3 gp bep, wp/gp/bep None
    without a projection)."""

    @staticmethod
    def forward(ctx, x, stride, n_segment, n_div, eps, *params):
        st = BlockTrainState(x.contiguous(), params, stride, n_segment,
                             n_div, eps)
        ctx.state = st
        ctx.dtypes = [None if p is None else p.dtype for p in params]
        stats = st.stats_tuple()
        ctx.mark_non_differentiable(*stats)
        return (st.y, *stats)

    @staticmethod
    def backward(ctx, dy, *_dstats):
        dx, grads = ctx.state.backward(dy)
        ctx.state = None
        grads = [None if g is None else g.to(dt)
                 for g, dt in zip(grads, ctx.dtypes)]
        return (dx, None, None, None, None, *grads)


def _block(x, params, stride, n_segment, n_div, eps):
    if x.device.type == "cpu":
        w1, w2, w3, wp, g1, be1, g2, be2, g3, be3, gp, bep = params
        return tsm_block_train_reference(
            x, w1, w2, w3, g1, be1, g2, be2, g3, be3, n_segment, n_div, eps,
            wp, gp, bep, stride)
    if x.device.type != "cuda":
        raise NotImplementedError(f"training bottleneck on {x.device}")
    y, *stats = _BlockTrain.apply(x, stride, n_segment, n_div, eps, *params)
    return y, tuple(stats)


def tsm_bottleneck_train(x, w1, w2, w3, g1, be1, g2, be2, g3, be3,
                         n_segment: int, n_div: int = 8, eps: float = 1e-5
                         ) -> Tuple[torch.Tensor, tuple]:
    """Stride-1 bottleneck, identity residual: x [N*T, H, W, C] ->
    (y [N*T, H, W, C], (mu1, var1, mu2, var2, mu3, var3))."""
    params = (w1, w2, w3, None, g1, be1, g2, be2, g3, be3, None, None)
    return _block(x, params, 1, n_segment, n_div, eps)


def tsm_bottleneck_proj_train(x, w1, w2, w3, wp, g1, be1, g2, be2, g3, be3,
                              gp, bep, n_segment: int, n_div: int = 8,
                              eps: float = 1e-5):
    """Stride-1 projection bottleneck (layer 1's block 0): -> (y, (mu1,
    var1, mu2, var2, mu3, var3, mup, varp))."""
    params = (w1, w2, w3, wp, g1, be1, g2, be2, g3, be3, gp, bep)
    return _block(x, params, 1, n_segment, n_div, eps)


def tsm_bottleneck_s2_train(x, w1, w2, w3, wp, g1, be1, g2, be2, g3, be3,
                            gp, bep, n_segment: int, n_div: int = 8,
                            eps: float = 1e-5):
    """Stride-2 projection bottleneck (block 0 of layers 2-4; the stride
    sits on the 3x3 and the projection): x [N*T, H, W, C] -> (y [N*T,
    H/2, W/2, Co], 8 stats). bn1 counts N*T*H*W pixels, the others the
    half-resolution count."""
    params = (w1, w2, w3, wp, g1, be1, g2, be2, g3, be3, gp, bep)
    return _block(x, params, 2, n_segment, n_div, eps)
