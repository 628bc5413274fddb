"""Inference TSM bottleneck (kernels K2/K3 at stride 1, K4 at stride 2).

`tsm_bottleneck` replaces the JAX package's
ops/tsm_block_pallas.py:tsm_bottleneck_pallas (`_kernel` for layer 1 with
its stride-1 projection block0, `_kernel_flat` for the plain blocks of
layers 2-4); `tsm_bottleneck_s2` replaces tsm_bottleneck_s2_pallas and
tsm_bottleneck_s2_planar_pallas (the planar input is a row-major view of
NHWC, so one NHWC kernel serves both). Both launch K5's kernel
(ops/tsm_conv.py, csrc/tsm_conv.cu) for conv1, then csrc/tsm_bottleneck.cu
for the rest:

    y1  = relu(bn1(conv1x1(temporal_shift(x))))
    y2  = relu(bn2(conv3x3(y1, stride)))
    out = relu(bn3(conv1x1(y2)) + (x or bn_p(conv1x1(x, stride))))

On the card C, F and Cout must be multiples of 64 (every ResNet-50 width
is); other widths raise.

`tsm_bottleneck_chain` (kernel K15) replaces tsm_bottleneck_chain_pallas
and tsm_bottleneck_halo_chain_pallas: a run of consecutive stride-1
plain blocks in one launch of csrc/tsm_chain.cu. `tsm_bottleneck_halo_chain`
is the same function (its halo tiling exists for VMEM only), so it runs
the same launch.

`tsm_bottleneck_reference` and `tsm_bottleneck_chain_plain` are the plain
versions. A CPU tensor takes them; a CUDA tensor launches the kernel. Weights come in the JAX package's
layout: w1 [C, F], w2 [3, 3, F, F] (HWIO), w3 [F, Cout], wp [C, Cout];
s*/b* are the inference-folded BatchNorm scale and bias.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build, _calls
from .temporal_shift import temporal_shift_reference
from .tsm_conv import _launch as _shift_conv1x1
from .tsm_conv import pair_aligned


def tsm_bottleneck_reference(x, w1, w2, w3, s1, b1, s2, b2, s3, b3,
                             n_segment: int, n_div: int = 8, wp=None,
                             sp=None, bp=None, stride: int = 1):
    """Plain version on NHWC x [N*T, H, W, C]; returns [N*T, Ho, Wo, Cout].
    Convolutions run in x.dtype; the BN affines, the residual sum and the
    ReLUs in float32, rounded to x.dtype after each ReLU."""
    dt = x.dtype
    y = (temporal_shift_reference(x, n_segment, n_div) if n_segment > 0
         else x)
    y = F.conv2d(y.permute(0, 3, 1, 2), _as_oihw(w1, dt))
    y1 = torch.relu(y * _col(s1) + _col(b1)).to(dt)
    return bottleneck_tail_reference(y1.permute(0, 2, 3, 1), x, w2, w3, s2,
                                     b2, s3, b3, wp, sp, bp, stride)


def _col(v):
    return v.float()[:, None, None]


def _as_oihw(w, dt):
    """HWIO (or a 1x1's [Cin, Cout]) -> OIHW in dt."""
    if w.dim() == 2:
        w = w.reshape(1, 1, *w.shape)
    return w.permute(3, 2, 0, 1).to(dt)


def bottleneck_tail_reference(y1, x, w2, w3, s2, b2, s3, b3, wp=None,
                              sp=None, bp=None, stride: int = 1):
    """The block after its conv1: y1 = relu(bn1(conv1(shift(x)))) NHWC,
    then relu(bn2(conv3x3(y1, stride))), bn3(conv1x1(.)), plus x or the
    projection bn_p(conv1x1(x, stride)), and the last ReLU; as
    tsm_bottleneck_reference computes them. -> NHWC in x.dtype."""
    dt = x.dtype
    y = F.conv2d(y1.permute(0, 3, 1, 2), _as_oihw(w2, dt), stride=stride,
                 padding=1)
    y = torch.relu(y * _col(s2) + _col(b2)).to(dt)
    y = F.conv2d(y, _as_oihw(w3, dt))
    y = y * _col(s3) + _col(b3)
    res = x.permute(0, 3, 1, 2)
    if wp is not None:
        res = F.conv2d(res, _as_oihw(wp, dt), stride=stride) * _col(sp) \
            + _col(bp)
    out = torch.relu(y + res).to(dt)
    return out.permute(0, 2, 3, 1).contiguous()


def _lib(stride: int):
    lib = _build.load("tsm_bottleneck")
    fn = getattr(lib, f"vcg_tsm_bottleneck_s{stride}")
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(stride, x, w1, w2, w3, s1, b1, s2, b2, s3, b3, n_segment,
            n_div, wp, sp, bp):
    nt, h, w, c = x.shape
    f = w1.shape[1]
    cout = w3.shape[1]
    bf = torch.bfloat16
    if x.dtype != bf or not x.is_contiguous():
        raise ValueError("the bottleneck kernel takes contiguous bf16 NHWC")
    shapes = {"w1": (w1, (c, f)), "w2": (w2, (3, 3, f, f)),
              "w3": (w3, (f, cout))}
    if wp is not None:
        shapes["wp"] = (wp, (c, cout))
    for name, (t, want) in shapes.items():
        if (tuple(t.shape) != want or t.dtype != bf or not t.is_contiguous()
                or t.device != x.device):
            raise ValueError(f"{name} must be contiguous bf16 {want} on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)}")
    vecs = [s1, b1, s2, b2, s3, b3] + ([sp, bp] if wp is not None else [])
    for v in vecs:
        if v.dtype != torch.float32 or v.device != x.device:
            raise ValueError("BN scale/bias must be float32 on the device")
    if wp is None and (stride != 1 or cout != c):
        raise ValueError("an identity residual needs stride 1 and Cout == C")
    fold = c // n_div if n_segment > 0 else 0
    if c % 64 or f % 64 or cout % 64 or fold % 8 or nt % max(n_segment, 1):
        raise ValueError(f"unsupported widths C={c} F={f} Cout={cout} "
                         f"fold={fold} N*T={nt} T={n_segment}: the kernel "
                         "takes C, F and Cout in multiples of 64")
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    dev = x.device
    # conv1 is K5's launch (counted as part of this block, not as K5)
    y1 = _shift_conv1x1(x, w1, s1, b1, n_segment, n_div, relu=True)
    y2 = torch.empty(nt, ho, wo, f, dtype=bf, device=dev)
    # the stride-2 projection's own output (stride 1 folds it into conv3)
    r = (torch.empty(nt, ho, wo, cout, dtype=bf, device=dev)
         if wp is not None and stride == 2 else None)
    out = torch.empty(nt, ho, wo, cout, dtype=bf, device=dev)
    # held here until the launch: the epilogues read them in float pairs
    s2, b2, s3, b3 = map(pair_aligned, (s2, b2, s3, b3))
    sp, bp = (None, None) if wp is None else map(pair_aligned, (sp, bp))
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = _calls.on_device(
        _lib(stride), dev, y1.data_ptr(), x.data_ptr(), w2.data_ptr(),
        w3.data_ptr(), ptr(wp), s2.data_ptr(), b2.data_ptr(), s3.data_ptr(),
        b3.data_ptr(), ptr(sp), ptr(bp), y2.data_ptr(), ptr(r),
        out.data_ptr(), nt, h, w, c, f, cout)
    return rc, out


def tsm_bottleneck(x, w1, w2, w3, s1, b1, s2, b2, s3, b3, n_segment: int,
                   n_div: int = 8, wp=None, sp=None, bp=None):
    """Stride-1 bottleneck, x [N*T, H, W, C] -> [N*T, H, W, Cout]; with
    wp/sp/bp the residual goes through the 1x1 projection (layer 1's
    block0), else it is x itself."""
    if x.device.type == "cpu":
        return tsm_bottleneck_reference(x, w1, w2, w3, s1, b1, s2, b2, s3,
                                        b3, n_segment, n_div, wp, sp, bp)
    if x.device.type != "cuda":
        raise NotImplementedError(f"tsm_bottleneck on {x.device}")
    _calls.refuse_grad("tsm_bottleneck", x)
    rc, out = _launch(1, x, w1, w2, w3, s1, b1, s2, b2, s3, b3, n_segment,
                      n_div, wp, sp, bp)
    _calls.count(tsm_bottleneck)
    if rc != 0:
        raise RuntimeError(f"tsm_bottleneck kernel failed: CUDA error {rc}")
    return out


def tsm_bottleneck_s2(x, w1, w2, w3, s1, b1, s2, b2, s3, b3, wp, sp, bp,
                      n_segment: int, n_div: int = 8):
    """Stride-2 downsample bottleneck (block0 of layers 2-4):
    x [N*T, H, W, C] -> [N*T, H/2, W/2, Cout], 3x3 stride on conv2 and a
    stride-2 1x1 projection residual on the unshifted x."""
    if x.device.type == "cpu":
        return tsm_bottleneck_reference(x, w1, w2, w3, s1, b1, s2, b2, s3,
                                        b3, n_segment, n_div, wp, sp, bp,
                                        stride=2)
    if x.device.type != "cuda":
        raise NotImplementedError(f"tsm_bottleneck_s2 on {x.device}")
    _calls.refuse_grad("tsm_bottleneck_s2", x)
    rc, out = _launch(2, x, w1, w2, w3, s1, b1, s2, b2, s3, b3, n_segment,
                      n_div, wp, sp, bp)
    _calls.count(tsm_bottleneck_s2)
    if rc != 0:
        raise RuntimeError(f"tsm_bottleneck_s2 kernel failed: CUDA error {rc}")
    return out


tsm_bottleneck.launches = 0
tsm_bottleneck_s2.launches = 0


def tsm_bottleneck_chain_plain(x, blocks, n_segment: int, n_div: int = 8,
                               planar_out: bool = False):
    """Plain version of the chain: tsm_bottleneck_reference of each block
    in turn; with planar_out, the pair-merged view [N*T, H, W/2, 2C]."""
    for blk in blocks:
        x = tsm_bottleneck_reference(x, *blk, n_segment, n_div)
    return pair_merge(x) if planar_out else x


def pair_merge(x: torch.Tensor) -> torch.Tensor:
    """NHWC [N*T, H, W, C] as the TPU kernels' pair-merged ("planar")
    layout [N*T, H, W/2, 2C]: a view."""
    nt, h, w, c = x.shape
    if w % 2:
        raise ValueError(f"a pair-merged layout needs an even width, got {w}")
    return x.view(nt, h, w // 2, 2 * c)


_MAX_CHAIN = 24  # csrc/tsm_chain.cu kMaxChain


def _chain_lib():
    fn = _build.load("tsm_chain").vcg_tsm_bottleneck_chain
    if fn.argtypes is None:
        arr = ctypes.POINTER(ctypes.c_void_p)
        fn.argtypes = ([ctypes.c_void_p] + [arr] * 9 + [ctypes.c_void_p] * 6
                       + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def tsm_bottleneck_chain(x, blocks, n_segment: int, n_div: int = 8,
                         planar_out: bool = False):
    """A chain of stride-1 non-projection bottlenecks (blocks 1.. of a
    stage), x [N*T, H, W, C] -> [N*T, H, W, C], or with planar_out the
    pair-merged view [N*T, H, W/2, 2C] of it. blocks: one tuple per block
    (w1 [C, F], w2 [3, 3, F, F], w3 [F, C], s1, b1, s2, b2 [F], s3, b3 [C])
    in tsm_bottleneck's layouts. On a CUDA tensor one launch of the K15
    kernel, counted in tsm_bottleneck_chain.launches."""
    blocks = [tuple(b) for b in blocks]
    if x.device.type == "cpu":
        return tsm_bottleneck_chain_plain(x, blocks, n_segment, n_div,
                                          planar_out)
    if x.device.type != "cuda":
        raise NotImplementedError(f"tsm_bottleneck_chain on {x.device}")
    _calls.refuse_grad("tsm_bottleneck_chain", x)
    nt, h, w, c = x.shape
    bf = torch.bfloat16
    if x.dtype != bf or not x.is_contiguous():
        raise ValueError("the chain kernel takes contiguous bf16 NHWC")
    if not 1 <= len(blocks) <= _MAX_CHAIN:
        raise ValueError(f"a chain of {len(blocks)} blocks: 1 to "
                         f"{_MAX_CHAIN}")
    f = blocks[0][0].shape[1]
    fold = c // n_div if n_segment > 0 else 0
    if c % 64 or f % 64 or fold % 8 or nt % max(n_segment, 1):
        raise ValueError(f"unsupported widths C={c} F={f} fold={fold} "
                         f"N*T={nt} T={n_segment}")
    shapes = ((c, f), (3, 3, f, f), (f, c)) + ((f,),) * 4 + ((c,),) * 2
    for k, blk in enumerate(blocks):
        if len(blk) != 9:
            raise ValueError("a chain block is (w1, w2, w3, s1, b1, s2, b2, "
                             "s3, b3)")
        for i, (t, want) in enumerate(zip(blk, shapes)):
            dt = bf if i < 3 else torch.float32
            if (tuple(t.shape) != want or t.dtype != dt or t.device != x.device
                    or not t.is_contiguous()):
                raise ValueError(f"block {k} tensor {i} must be contiguous "
                                 f"{dt} {want} on {x.device}, got {t.dtype} "
                                 f"{tuple(t.shape)}")
    dev = x.device
    n = len(blocks)
    y1 = torch.empty(nt * h * w, f, dtype=bf, device=dev)
    y2 = torch.empty(nt * h * w, f, dtype=bf, device=dev)
    bufs = [torch.empty_like(x) if n > k + 1 else None for k in range(2)]
    bar = torch.zeros(2, dtype=torch.int32, device=dev)
    out = torch.empty_like(x)
    # the epilogues read the BN vectors in float pairs
    blocks = [blk[:3] + tuple(map(pair_aligned, blk[3:])) for blk in blocks]
    ptrs = [(ctypes.c_void_p * n)(*(blk[i].data_ptr() for blk in blocks))
            for i in range(9)]
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = _calls.on_device(
        _chain_lib(), dev, x.data_ptr(), *ptrs, y1.data_ptr(), y2.data_ptr(),
        ptr(bufs[0]), ptr(bufs[1]), bar.data_ptr(), out.data_ptr(), n, nt, h,
        w, c, f, max(n_segment, 1), fold)
    _calls.count(tsm_bottleneck_chain)
    if rc != 0:
        raise RuntimeError(f"tsm_bottleneck_chain kernel failed: CUDA error "
                           f"{rc}")
    return pair_merge(out) if planar_out else out


def tsm_bottleneck_halo_chain(x, blocks, n_segment: int, n_div: int = 8,
                              planar_out: bool = False):
    """tsm_block_pallas.py:978 tsm_bottleneck_halo_chain_pallas: the same
    function as tsm_bottleneck_chain (its row tiles with halos are a VMEM
    workaround of the TPU), so the same plain version and the same K15
    launch, counted in tsm_bottleneck_chain.launches."""
    return tsm_bottleneck_chain(x, blocks, n_segment, n_div, planar_out)


tsm_bottleneck_chain.launches = 0
