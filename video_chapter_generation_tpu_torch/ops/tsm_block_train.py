"""Training-mode TSM bottleneck with batch-statistics BatchNorm (kernel K12),
and the links that fuse it across the blocks of the trunk (kernel K13).

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
plus explicit batch-stat BN, differentiated by autograd; under a moment
group of parallel/dist.py its BN takes the group's statistics). A CUDA tensor
runs csrc/conv_train.cu through `_BlockTrain`, a torch.autograd.Function
whose forward is two C calls (`block_train_fwd` up to p, `finale_fwd`)
and whose backward is two (`finale_bwd`, `block_train_bwd`); there is no
fallback to the plain version.

Under a moment group (data-parallel training), `vcg_block_train_fwd`
and `vcg_block_train_bwd` run one phase a call (`run_phases`), each
ending where a BN moment is complete, and the wrapper reduces that
moment over the group on the current stream before the next phase's
statistics take it, with the group's pixel count; the moments of
`finale_bwd` and `trunk_link_bwd` are reduced as they return. Alone,
each entry is one call of its whole range: the launches and bits of the
single-card path.

The trunk (ops/tsm_trunk_train.py) calls the same entries through
`BlockTrainState` and replaces every finale but the top block's by the
two links of tsm_trunk_train_pallas.py (`_fk1`/`_bk1`/`_bk1_s2` with
prev): `trunk_link_fwd` (block N's conv1, computing block N-1's finale
as it loads and writing block N's input once) and `trunk_link_bwd`
(block N's conv1 data gradient, whose epilogue applies block N-1's relu
mask and takes its BN3/BNp backward moments). Their plain versions are
`trunk_link_fwd_reference` and `trunk_link_bwd_reference`.

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

from ..parallel import dist
from . import _build, _calls
from .temporal_shift import temporal_shift_reference


def at_least_f32(v: torch.Tensor) -> torch.Tensor:
    """float32 for half types; float32/float64 stay as they are."""
    return v if v.dtype in (torch.float32, torch.float64) else v.float()


def bn_train(v: torch.Tensor, gamma, beta, eps: float, dims=(0, 1, 2)):
    """Batch-statistics BatchNorm as the JAX package computes it: mean and
    biased variance E[v^2] - mu^2 in at least float32 over `dims`, the
    normalized output cast back to v's dtype. Returns (out, mu, var) with
    the statistics detached (running averages do not backprop).

    Under a moment group (parallel/dist.py) the statistics are the
    group's: (sum, sum of squares, count) summed over its processes by
    the differentiable all_reduce_sum, so the input gradient also flows
    through the other processes' rows."""
    vf = at_least_f32(v)
    ch = [d for d in range(v.dim()) if d not in dims][0]
    mg = dist.moment_group()
    if mg is None:
        mu = vf.mean(dims)
        var = (vf * vf).mean(dims) - mu * mu
    else:
        c = v.shape[ch]
        sums = dist.all_reduce_sum(torch.cat([
            vf.sum(dims), (vf * vf).sum(dims),
            vf.new_full((1,), float(v.numel() // c))]), mg)
        count = sums[-1].detach()
        mu = sums[:c] / count
        var = sums[c:2 * c] / count - mu * mu
    shape = [1] * v.dim()
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
                              stride: int = 1, conv1=None):
    """Plain version on NHWC x [N*T, H, W, C] -> (y, stats). conv1(x, w1
    [C, F]), when given, makes u in place of the shift and the 1x1
    product (models/resnet.py's per-block training path: its tsm_impl)."""
    c = x.shape[-1]
    if conv1 is not None:
        u = conv1(x, w1.reshape(c, -1))
    else:
        xs = (temporal_shift_reference(x, n_segment, n_div) if n_segment > 0
              else x)
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


def finale_reference(p, r, sa3, sb3, sap=None, sbp=None):
    """Plain version of a block's finale: relu(bn3(p) + r') with r' = r
    (identity) or bnp(r) (sap given), each BN affine rounded to p's dtype
    and the add and relu in at least float32, as the kernels round."""
    dt = p.dtype
    a3 = (at_least_f32(p) * sa3 + sb3).to(dt)
    rr = r if sap is None else (at_least_f32(r) * sap + sbp).to(dt)
    return torch.relu(at_least_f32(a3) + at_least_f32(rr)).to(dt)


def trunk_link_fwd_reference(p, r, sa3, sb3, sap, sbp, w1, n_segment: int,
                             n_div: int = 8):
    """Plain version of the trunk's forward link (trunk_link_fwd): block
    N's input x = finale_reference(p, r, ...) of block N-1, u =
    conv1x1(shift(x), w1 [C, F]) in x's dtype, and mom [2, F] = (sum u,
    sum u^2) in at least float32. Returns (x, u, mom)."""
    x = finale_reference(p, r, sa3, sb3, sap, sbp)
    u = conv_nhwc(temporal_shift_reference(x, n_segment, n_div),
                  w1.reshape(x.shape[-1], -1))
    uf = at_least_f32(u)
    return x, u, torch.stack([uf.sum((0, 1, 2)), (uf * uf).sum((0, 1, 2))])


def trunk_link_bwd_reference(du, w1, res, x, p, pr, mu3, mup,
                             n_segment: int, n_div: int = 8):
    """Plain version of the trunk's backward link (trunk_link_bwd): block
    N's input gradient dx = unshift(conv1x1(du, w1^T)) + res, rounded to
    du's dtype; block N-1's dq = dx * (x > 0), with x block N's input (the
    relu output of block N-1's finale); and that block's BN3/BNp backward
    moments mom [3, C] = (sum dq, sum dq (p - mu3), sum dq (pr - mup), a
    row of zeros without pr) in at least float32. du is the gradient of
    block N's u (BN1's backward applied). Returns (dq, mom)."""
    c = x.shape[-1]
    dxm = conv_nhwc(du, w1.reshape(c, -1).t())
    dx = (at_least_f32(temporal_shift_reference(dxm, n_segment, n_div,
                                                reverse=True))
          + at_least_f32(res)).to(du.dtype)
    dq = torch.where(x > 0, dx, torch.zeros_like(dx))
    dqf = at_least_f32(dq)
    dims = (0, 1, 2)
    rows = [dqf.sum(dims), (dqf * (at_least_f32(p) - mu3)).sum(dims),
            (dqf * (at_least_f32(pr) - mup)).sum(dims) if pr is not None
            else torch.zeros_like(mu3, dtype=dqf.dtype)]
    return dq, torch.stack(rows)


# ---------------------------------------------------------------------------
# the CUDA kernels (csrc/conv_train.cu)
# ---------------------------------------------------------------------------


def _fn(name: str, n_ptr: int, n_int: int, eps: bool = True,
        phased: bool = False):
    """The C entry with its argument types: n_ptr pointers, n_int ints,
    eps, and where phased the phase range (from, to) and the count
    scale."""
    fn = getattr(_build.load("conv_train"), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + ([ctypes.c_float] if eps else [])
                       + ([ctypes.c_int, ctypes.c_int, ctypes.c_double]
                          if phased else []) + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def run_phases(fn, dev, args, phases: int, reduce, scale: float) -> int:
    """Call a phased entry: alone, its whole range (0, phases) at once;
    under a moment group one call a phase, with reduce(i) between phase
    i and i + 1 (the moments phase i completed, summed or averaged over
    the group). Returns the first nonzero CUDA error code, or 0."""
    if dist.moment_group() is None:
        return _calls.on_device(fn, dev, *args, 0, phases, 1.0)
    for i in range(phases):
        rc = _calls.on_device(fn, dev, *args, i, i + 1, scale)
        if rc != 0:
            return rc
        if i + 1 < phases:
            reduce(i)
    return 0


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _counted(wrapper, rc: int):
    """Count one launch of wrapper's entry; raise if it failed."""
    _calls.count(wrapper)
    if rc != 0:
        raise RuntimeError(f"{wrapper.__name__} kernel failed: CUDA error "
                           f"{rc}")


def _workspace(device, nt, h, w, c, f, co, stride) -> torch.Tensor:
    """The float32 scratch of per-block partial sums the entries need
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
                    eps: float, linked=None):
    """vcg_block_train_fwd (one call, or one a phase under a moment
    group, counted as one launch): the block's forward up to p, no
    finale. wf: kernel_weights(...)[0]; gb: pack_affines(...); linked:
    (u, mom) from trunk_link_fwd, whose launch was this block's conv1.
    Returns (stats, vec, (u, z, p, pr))."""
    w1, w2, w3, wp = wf
    f, co = w1.shape[1], w3.shape[1]
    nt, h, w, c, fold = _check(x, f, co, stride, n_segment, n_div,
                               wp is not None)
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    dev, bf = x.device, torch.bfloat16
    n_vec = 4 * f + 4 * co
    stats, vec = torch.empty(2, n_vec, dtype=torch.float32,
                             device=dev).unbind(0)
    if linked is None:
        u = torch.empty(nt, h, w, f, dtype=bf, device=dev)
        mom = torch.empty(n_vec, dtype=torch.float32, device=dev)
    else:
        u, mom = linked
    z = torch.empty(nt, ho, wo, f, dtype=bf, device=dev)
    p = torch.empty(nt, ho, wo, co, dtype=bf, device=dev)
    pr = torch.empty_like(p) if wp is not None else None
    part = _workspace(dev, nt, h, w, c, f, co, stride)
    mg = dist.moment_group()
    # under a moment group: sum m1 (and, with m3, mp) over the group
    # before the statistics that use them
    sums = (mom[:2 * f], mom[2 * f:4 * f],
            mom[4 * f:4 * f + (4 if wp is not None else 2) * co])
    rc = run_phases(
        _fn("vcg_block_train_fwd", 14, 10, phased=True), dev,
        (x.data_ptr(), w1.data_ptr(), w2.data_ptr(), w3.data_ptr(), _ptr(wp),
         gb.data_ptr(), u.data_ptr(), z.data_ptr(), p.data_ptr(), _ptr(pr),
         stats.data_ptr(), vec.data_ptr(), mom.data_ptr(), part.data_ptr(),
         nt, h, w, c, f, co, stride, n_segment, fold,
         int(linked is not None), eps), 4,
        lambda i: mg.sum_(sums[i]), mg and mg.count_scales(nt)[0])
    _counted(block_train_fwd, rc)
    return stats, vec, (u, z, p, pr)


def finale_fwd(p, r, vec, f: int, co: int, proj: bool) -> torch.Tensor:
    """One launch of vcg_finale_fwd: y = relu(bn3(p) + (r or bnp(r)))
    with the block's vec (r is the block input, or pr when proj)."""
    y = torch.empty_like(p)
    rc = _calls.on_device(
        _fn("vcg_finale_fwd", 4, 4, eps=False), p.device,
        p.data_ptr(), r.data_ptr(), vec.data_ptr(), y.data_ptr(),
        p.numel() // co, f, co, int(proj))
    _counted(finale_fwd, rc)
    return y


def _mean_moments(mom: torch.Tensor) -> torch.Tensor:
    """Backward moments averaged over the moment group, in place (as they
    are alone): see parallel/dist.py:MomentGroup for why the mean."""
    mg = dist.moment_group()
    return mom if mg is None else mg.mean_(mom)


def finale_bwd(dy, y, p, pr, stats, f: int, co: int, part):
    """One launch of vcg_finale_bwd: dq = dy * (y > 0) and mom3 [3Co] =
    (sum dq, sum dq (p - mu3), sum dq (pr - mup), 0 without pr),
    averaged over the moment group where there is one."""
    dy = dy.to(torch.bfloat16).contiguous()
    dq = torch.empty_like(p)
    mom3 = torch.empty(3 * co, dtype=torch.float32, device=p.device)
    rc = _calls.on_device(
        _fn("vcg_finale_bwd", 8, 3, eps=False), p.device,
        dy.data_ptr(), y.data_ptr(), p.data_ptr(), _ptr(pr),
        stats.data_ptr(), dq.data_ptr(), mom3.data_ptr(), part.data_ptr(),
        p.numel() // co, f, co)
    _counted(finale_bwd, rc)
    return dq, _mean_moments(mom3)


def block_train_bwd(dq, mom3, x, saved, wb, gb, stats, vec, stride: int,
                    n_segment: int, n_div: int, eps: float,
                    link: bool = False):
    """vcg_block_train_bwd (one call, or one a phase under a moment group,
    counted as one launch) from dq and mom3 (finale_bwd, or the block
    above's trunk_link_bwd). wb: kernel_weights(...)[1].
    Returns (dx, dw1, dw2 [9F, F], dw3, dwp or None, dgb, da1, abc1) with
    the weight and affine gradients in float32. link: conv1's data
    gradient is left to trunk_link_bwd (which takes da1 and abc1, BN1's
    backward vectors); dx is then the projection's data gradient, or None
    without a projection."""
    u, z, p, pr = saved
    w1t, w2t, w3t, wpt = wb
    f, co = w1t.shape[0], w3t.shape[0]
    proj = wpt is not None
    nt, h, w, c, fold = _check(x, f, co, stride, n_segment, n_div, proj)
    dev, bf, f32 = x.device, torch.bfloat16, torch.float32
    dx = (torch.empty(nt, h, w, c, dtype=bf, device=dev)
          if proj or not link else None)
    dw1 = torch.empty(c, f, dtype=f32, device=dev)
    dw2 = torch.empty(9 * f, f, dtype=f32, device=dev)
    dw3 = torch.empty(f, co, dtype=f32, device=dev)
    dwp = torch.empty(c, co, dtype=f32, device=dev) if proj else None
    dgb = torch.empty(4 * f + 4 * co, dtype=f32, device=dev)
    da2 = torch.empty_like(z)
    da1 = torch.empty_like(u)
    work = torch.empty(10 * f + 6 * co, dtype=f32, device=dev)
    part = _workspace(dev, nt, h, w, c, f, co, stride)
    mg = dist.moment_group()
    # under a moment group: average the moments of da2, then of da1,
    # before the BN backward that uses them (mom3 came averaged)
    means = (work[:2 * f], work[2 * f:4 * f])
    rc = run_phases(
        _fn("vcg_block_train_bwd", 24, 10, phased=True), dev,
        (dq.data_ptr(), mom3.data_ptr(), x.data_ptr(), u.data_ptr(),
         z.data_ptr(), p.data_ptr(), _ptr(pr), w1t.data_ptr(),
         w2t.data_ptr(), w3t.data_ptr(), _ptr(wpt), gb.data_ptr(),
         stats.data_ptr(), vec.data_ptr(), _ptr(dx), dw1.data_ptr(),
         dw2.data_ptr(), dw3.data_ptr(), _ptr(dwp), dgb.data_ptr(),
         da2.data_ptr(), da1.data_ptr(), work.data_ptr(), part.data_ptr(),
         nt, h, w, c, f, co, stride, n_segment, fold, int(link), eps), 3,
        lambda i: mg.mean_(means[i]), mg and mg.count_scales(nt)[1])
    _counted(block_train_bwd, rc)
    return dx, dw1, dw2, dw3, dwp, dgb, da1, work[-3 * f:]


def trunk_link_fwd(st: "BlockTrainState", below: "BlockTrainState"):
    """One launch of vcg_trunk_link_fwd: block st's conv1 with the finale
    of the block below computed as it loads (from below's p, its residual
    and vec). Returns (x, u, mom): st's input, written once, its u and
    the moments of u in the first 2F floats of mom [4F + 4Co]."""
    p, r = below.saved[2], below.residual()
    nt, h, w, c = p.shape
    w1 = st.wf[0]
    fold = c // st.n_div
    dev = p.device
    x = torch.empty_like(p)
    u = torch.empty(nt, h, w, st.f, dtype=torch.bfloat16, device=dev)
    mom = torch.empty(4 * st.f + 4 * st.co, dtype=torch.float32, device=dev)
    part = _workspace(dev, nt, h, w, c, st.f, st.co, st.stride)
    rc = _calls.on_device(
        _fn("vcg_trunk_link_fwd", 8, 9, eps=False), dev,
        p.data_ptr(), r.data_ptr(), below.vec.data_ptr(), w1.data_ptr(),
        x.data_ptr(), u.data_ptr(), mom.data_ptr(), part.data_ptr(),
        nt, h, w, c, st.f, below.f, int(below.proj), st.t, fold)
    _counted(trunk_link_fwd, rc)
    return x, u, mom


def trunk_link_bwd(st: "BlockTrainState", below: "BlockTrainState", res):
    """One launch of vcg_trunk_link_bwd: block st's conv1 data gradient
    (from the da1 and abc1 its backward(link=True) kept) unshifted onto
    res, masked by st's input into the dq of the block below, with that
    block's BN3/BNp backward moments. Returns (dq, mom3 [3C])."""
    x, u = st.x, st.saved[0]
    nt, h, w, c = x.shape
    fold = c // st.n_div
    dev = x.device
    dq = torch.empty_like(x)
    mom3 = torch.empty(3 * c, dtype=torch.float32, device=dev)
    part = _workspace(dev, nt, h, w, c, st.f, st.co, st.stride)
    rc = _calls.on_device(
        _fn("vcg_trunk_link_bwd", 12, 8, eps=False), dev,
        st.da1.data_ptr(), u.data_ptr(), st.abc1.data_ptr(),
        st.wb[0].data_ptr(), res.data_ptr(), x.data_ptr(),
        below.saved[2].data_ptr(), _ptr(below.saved[3]),
        below.stats.data_ptr(), dq.data_ptr(), mom3.data_ptr(),
        part.data_ptr(), nt, h, w, c, st.f, below.f, st.t, fold)
    _counted(trunk_link_bwd, rc)
    return dq, _mean_moments(mom3)


for _wrapper in (block_train_fwd, block_train_bwd, finale_fwd, finale_bwd,
                 trunk_link_fwd, trunk_link_bwd):
    _wrapper.launches = 0


class BlockTrainState:
    """One bottleneck on the CUDA kernels: its weights in the kernels'
    layouts and what its forward keeps for its backward: x (its input),
    saved = (u, z, p, pr), stats, vec and, where it ran its own finale,
    y."""

    def __init__(self, params, stride, n_segment, n_div, eps):
        w1, w2, w3, wp, g1, be1, g2, be2, g3, be3, gp, bep = params
        self.shapes = [t.shape for t in (w1, w2, w3, wp) if t is not None]
        self.wf, self.wb = kernel_weights(w1, w2, w3, wp)
        f, co = self.wf[0].shape[1], self.wf[2].shape[1]
        self.f, self.co, self.proj = f, co, wp is not None
        self.gb = pack_affines(f, co, g1, be1, g2, be2, g3, be3, gp, bep)
        self.stride, self.t, self.n_div, self.eps = (stride, n_segment,
                                                      n_div, eps)
        self.x = self.y = self.saved = None

    def forward(self, x=None, below=None):
        """The forward up to p, from the input x or, in the trunk, from
        the block below through trunk_link_fwd."""
        linked = None
        if below is not None:
            x, u, mom = trunk_link_fwd(self, below)
            linked = (u, mom)
        self.x = x
        self.stats, self.vec, self.saved = block_train_fwd(
            x, self.wf, self.gb, self.stride, self.t, self.n_div, self.eps,
            linked)

    def residual(self):
        """What the finale adds to bn3(p): pr (through BNp) or x."""
        return self.saved[3] if self.proj else self.x

    def finale(self):
        self.y = finale_fwd(self.saved[2], self.residual(), self.vec, self.f,
                            self.co, self.proj)
        return self.y

    def finale_backward(self, dy):
        """-> (dq, mom3) of the block's own finale (needs its y and p)."""
        part = _workspace(self.x.device, *self.x.shape, self.f, self.co,
                          self.stride)
        return finale_bwd(dy, self.y, self.saved[2], self.saved[3],
                          self.stats, self.f, self.co, part)

    def set_p(self, p):
        u, z, _, pr = self.saved
        self.saved = (u, z, p, pr)

    def stats_tuple(self):
        return split_stats(self.stats, self.f, self.co, self.proj)

    def backward(self, dq, mom3, link=False):
        """From dq and mom3 -> (dx, grads in the parameter order w1 w2 w3
        wp g1 be1 g2 be2 g3 be3 gp bep; None for an absent projection).
        link: conv1's data gradient is left to trunk_link_bwd: dx is then
        the residual gradient it adds to (dq itself, or the projection's
        data gradient), and da1 and abc1 stay here for it."""
        dx, dw1, dw2, dw3, dwp, dgb, da1, abc1 = block_train_bwd(
            dq, mom3, self.x, self.saved, self.wb, self.gb, self.stats,
            self.vec, self.stride, self.t, self.n_div, self.eps, link)
        if link:
            self.da1, self.abc1 = da1, abc1
            if dx is None:
                dx = dq
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
    without a projection). Its activations are saved through autograd,
    so a checkpoint around the block (model.remat_vision) drops them
    after the forward and makes them again for the backward."""

    @staticmethod
    def forward(ctx, x, stride, n_segment, n_div, eps, *params):
        st = BlockTrainState(params, stride, n_segment, n_div, eps)
        st.forward(x.contiguous())
        y = st.finale()
        ctx.save_for_backward(st.x, *st.saved, y)
        st.x = st.y = st.saved = None
        ctx.state = st
        ctx.dtypes = [None if p is None else p.dtype for p in params]
        stats = st.stats_tuple()
        ctx.mark_non_differentiable(*stats)
        return (y, *stats)

    @staticmethod
    def backward(ctx, dy, *_dstats):
        st = ctx.state
        x, u, z, p, pr, y = ctx.saved_tensors
        st.x, st.y, st.saved = x, y, (u, z, p, pr)
        dx, grads = st.backward(*st.finale_backward(dy))
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
