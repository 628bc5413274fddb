"""ResNet stems (kernels K1, K8 and K14b), all in csrc/stem_s2d.cu.

- `stem_s2d` replaces the JAX package's ops/stem_pallas.py:stem_s2d_pallas
  (K1): uint8 4x4 space-to-depth frames -> normalize, 7x7/2 conv, folded
  BN, ReLU, 3x3/2 max pool, one kernel launch: the phase-packed product of
  the TPU kernel ([cells, 432] x [432, 256], `stem_weight_im2col`) on the
  wgmma mainloop, the pool in its epilogue over strips of 2 cell rows, a
  frame wider than 64 cells in column chunks (`stem_chunks`;
  tests/test_torch_stem_phase.py holds the same decomposition in plain
  torch to the plain version);
- `stem_frames` replaces stem_pallas.py:stem_conv_bn_pool_pallas (K8):
  the same kernel on normalized NHWC frames, read as their 4x4 cells;
- `bn_relu_maxpool` replaces stem_pallas.py:bn_relu_maxpool_pallas (K8):
  folded BN + ReLU + 3x3/2 max pool (pad 1) on any NHWC activation;
- `stem_s2d_int8` replaces stem_pallas.py:stem_s2d_int8_pallas (K14b):
  the weight-only int8 stem on the raw uint8 s2d pack. x - 128 is an exact
  int8; per s2d cell one int8 product over the 3x3 cell neighbourhood
  gives the 4 conv-output phases, with the normalize scale folded into the
  per-output-channel int8 weight; the normalize bias and the +128 come
  back through one bias row per tap that lies inside the frame, then BN,
  ReLU and the 3x3/2 max pool: one launch on K1's strip walk, the int8
  weight resident in shared memory, the pool in the epilogue after each
  phase's affine (tests/test_torch_stem_int8_walk.py holds that epilogue
  in plain torch). Like the JAX package, no model path calls it (its
  models/resnet.py:687-693 keeps the bf16 stem with quantize=True).

Each has a plain version (`*_reference`). A CPU tensor takes the plain
version; a CUDA tensor launches the kernel, and any other device raises.
"""

from __future__ import annotations

import ctypes
import functools
import weakref

import numpy as np
import torch
import torch.nn.functional as F

from . import _build, _calls
from .preprocess import (
    affine_consts,
    depth_to_space4,
    norm_consts,
    normalize_frames_reference,
)
from .tsm_block_int8 import _idot, quantize_weight


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


_ARGS = {"vcg_stem_s2d": (6, 4), "vcg_stem_frames": (5, 4),
         "vcg_bn_relu_maxpool": (4, 4), "vcg_stem_s2d_int8": (5, 4)}

# a tile of the stem kernels holds 2 cell rows of at most 64 cells
STEM_TILE_CELLS = 64


def stem_chunks(ws: int) -> int:
    """Column chunks of a frame row of ws cells in the stem kernels' walk
    (csrc/stem_tiles.cuh:stem_chunks): one up to 64 cells, else chunks of
    at most 63 output cells, so that a pooling tile also holds the cell
    left of its first."""
    cap = STEM_TILE_CELLS
    return 1 if ws <= cap else -(-ws // (cap - 1))


def _lib(name: str):
    """The C entry `name` of csrc/stem_s2d.cu: (pointers, ints), stream."""
    fn = getattr(_build.load("stem_s2d"), name)
    if fn.argtypes is None:
        n_ptr, n_int = _ARGS[name]
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def stem_bands(n: int, hs: int, sms: int, halo: bool = True) -> int:
    """Bands a column chunk for the stem kernel's persistent walk over n
    column chunks (frames x stem_chunks) of hs cell rows on sms blocks (one
    an SM): a band is a run of strips (2 cell rows each), and, with halo
    (the pool's carry), one that starts below the frame's top recomputes
    the strip above it. The count minimizes the most strips a block walks,
    ceil(n * bands / sms) * (ceil(strips / bands) + [halo and bands > 1])."""
    strips = (hs + 1) // 2
    best = None
    for bands in range(1, strips + 1):
        walk = -(-n * bands // sms) * (-(-strips // bands)
                                       + (halo and bands > 1))
        if best is None or walk < best[0]:
            best = (walk, bands)
    return best[1]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _phase_weight(w7: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """HWIO [7, 7, 3, 64] -> the kernel's bf16 [448, 256]: the phase-packed
    im2col weight, K zero-padded 432 -> 448 (seven 64-deep stages). Kept
    for the last w7 seen on each device (the same tensor at the same
    version: a model's folded weight; a replica on each card has its
    own), since making it costs a host copy and a few launches, which a
    call would otherwise pay each time."""
    if tuple(w7.shape) != (7, 7, 3, 64):
        raise ValueError(f"w7 must be [7,7,3,64], got {tuple(w7.shape)}")
    key = (w7._version, w7.dtype)
    last = _phase_weight.last.get(dev)
    if last is not None and last[0]() is w7 and last[1] == key:
        return last[2]
    wk = torch.zeros(448, 256, dtype=torch.bfloat16, device=dev)
    wk[:432] = stem_weight_im2col(w7.to(dev)).to(torch.bfloat16)
    _phase_weight.last[dev] = (weakref.ref(w7), key, wk)
    return wk


_phase_weight.last = {}


def walk_bands(dev: torch.device, n: int, hs: int, ws: int,
               halo: bool = True) -> int:
    """stem_bands for n frames of hs x ws cells on dev's SMs."""
    sms = _sm_count(dev.index if dev.index is not None
                    else torch.cuda.current_device())
    return stem_bands(n * stem_chunks(ws), hs, sms, halo)


def _launch(entry: str, x: torch.Tensor, w7, scale, bias, hs: int,
            ws: int, *extra) -> torch.Tensor:
    """One launch of the stem kernel over n frames of hs x ws cells."""
    n, dev = x.shape[0], x.device
    wk = _phase_weight(w7, dev)
    scale = scale.to(device=dev, dtype=torch.float32).contiguous()
    bias = bias.to(device=dev, dtype=torch.float32).contiguous()
    out = torch.empty(n, hs, ws, 64, dtype=torch.bfloat16, device=dev)
    bands = walk_bands(dev, n, hs, ws)
    rc = _calls.on_device(_lib(entry), dev, x.data_ptr(), wk.data_ptr(),
                          scale.data_ptr(), bias.data_ptr(), *extra,
                          out.data_ptr(), n, hs, ws, bands)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc}")
    return out


def stem_s2d(s4: torch.Tensor, w7: torch.Tensor, scale: torch.Tensor,
             bias: torch.Tensor,
             out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Fused stem, s4 [N, h, w, 48] uint8 raw pixels -> [N, h, w, 64].

    w7 [7, 7, 3, 64] (HWIO); scale/bias [64] the inference-folded BN.
    On a CUDA tensor one launch, counted in stem_s2d.launches."""
    if s4.device.type == "cpu":
        return stem_s2d_reference(s4, w7, scale, bias, out_dtype)
    if s4.device.type != "cuda":
        raise NotImplementedError(f"stem_s2d on {s4.device}")
    n, h, w, c48 = s4.shape
    if (s4.dtype != torch.uint8 or c48 != 48 or not s4.is_contiguous()
            or s4.data_ptr() % 16):
        raise ValueError(f"stem_s2d takes contiguous, 16-byte aligned uint8 "
                         f"[N,h,w,48], got {s4.dtype} {tuple(s4.shape)}")
    if out_dtype != torch.bfloat16:
        raise ValueError("the stem kernel emits bfloat16")
    out = _launch("vcg_stem_s2d", s4, w7, scale, bias, h, w,
                  norm_consts(s4.device).data_ptr())
    _calls.count(stem_s2d)
    return out


def stem_frames(x: torch.Tensor, w7: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """Fused stem on normalized NHWC frames x [N, H, W, 3] (H == W,
    H % 4 == 0) -> [N, H/4, W/4, 64] in x's dtype (the kernel takes
    bf16). w7 [7, 7, 3, 64] (HWIO); scale/bias [64] the
    inference-folded BN. On a CUDA tensor one launch, counted in
    stem_frames.launches."""
    if x.device.type == "cpu":
        return stem_frames_reference(x, w7, scale, bias)
    if x.device.type != "cuda":
        raise NotImplementedError(f"stem_frames on {x.device}")
    _calls.refuse_grad("stem_frames", x)
    n, h, w, c = x.shape
    if (x.dtype != torch.bfloat16 or c != 3 or h != w or h % 4
            or not x.is_contiguous() or x.data_ptr() % 8):
        raise ValueError(f"stem_frames takes contiguous bf16 [N,H,H,3] with "
                         f"H % 4 == 0, got {x.dtype} {tuple(x.shape)}")
    out = _launch("vcg_stem_frames", x, w7, scale, bias, h // 4, w // 4)
    _calls.count(stem_frames)
    return out


def bn_relu_maxpool(x: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """relu(x * scale + bias) -> 3x3/2 max pool (pad 1): x [N, H, W, C] ->
    [N, (H+1)//2, (W+1)//2, C] (odd H and W too); scale/bias [C] (folded
    BN). The kernel takes bf16 with C % 8 == 0."""
    if x.device.type == "cpu":
        return bn_relu_maxpool_reference(x, scale, bias)
    if x.device.type != "cuda":
        raise NotImplementedError(f"bn_relu_maxpool on {x.device}")
    n, h, w, c = x.shape
    if x.dtype != torch.bfloat16 or c % 8 or not x.is_contiguous():
        raise ValueError(f"bn_relu_maxpool takes contiguous bf16 [N,H,W,C] "
                         f"with C % 8 == 0, got {x.dtype} {tuple(x.shape)}")
    if x.data_ptr() % 16:  # the kernel reads 16-byte vectors
        x = x.clone()
    dev = x.device
    scale, bias = [t.to(device=dev, dtype=torch.float32).contiguous()
                   for t in (scale, bias)]
    out = torch.empty(n, (h + 1) // 2, (w + 1) // 2, c, dtype=torch.bfloat16,
                      device=dev)
    rc = _calls.on_device(
        _lib("vcg_bn_relu_maxpool"), dev, x.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), out.data_ptr(), n, h, w, c)
    _calls.count(bn_relu_maxpool)
    if rc != 0:
        raise RuntimeError(f"bn_relu_maxpool kernel launch failed: CUDA "
                           f"error {rc}")
    return out


@functools.lru_cache(maxsize=None)
def _phase_selection() -> np.ndarray:
    """stem_pallas.py:125 _phase_selection: sel [4, 432, 147] float32,
    sel[ph, rk, dd] = 1 where row dd = (dr*7+dc)*3+c of the flattened
    [147, 64] stem kernel feeds im2col lane rk = tap_r*144 + tap_c*48 +
    ch48 of s2d cell (I, J) for output phase ph = pr*2+pc, the conv pixel
    (2I+pr, 2J+pc): dr = 4*tap_r + di - 2*pr - 1, dc likewise."""
    tr, tc, di, dj, c = (a.reshape(-1) for a in np.meshgrid(
        np.arange(3), np.arange(3), np.arange(4), np.arange(4),
        np.arange(3), indexing="ij"))
    sel = np.zeros((4, 432, 147), np.float32)
    for ph in range(4):
        p_r, p_c = ph // 2, ph % 2
        dr = 4 * tr + di - 2 * p_r - 1
        dc = 4 * tc + dj - 2 * p_c - 1
        valid = (dr >= 0) & (dr <= 6) & (dc >= 0) & (dc <= 6)
        rows = np.arange(432)[valid]
        sel[ph, rows, (dr[valid] * 7 + dc[valid]) * 3 + c[valid]] = 1.0
    return sel


@functools.lru_cache(maxsize=None)
def _selection_on(device: torch.device) -> torch.Tensor:
    """_phase_selection on device, copied there once (the training stem
    makes its weight every step)."""
    return torch.from_numpy(_phase_selection()).to(device)


def stem_weight_im2col(w7: torch.Tensor) -> torch.Tensor:
    """stem_pallas.py:111 _stem_weight_im2col in float32: the [7, 7, 3, 64]
    kernel as the phase-packed im2col weight [432, 256], column
    ph * 64 + f (each entry one weight or 0, so exact)."""
    sel = _selection_on(w7.device)
    w = w7.reshape(147, 64).float()
    return torch.einsum("prd,df->rpf", sel, w).reshape(432, 256)


def stem_int8_weights(w7: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor):
    """The int8 stem's weights (stem_pallas.py:380-400), on w7's device:
    (wq int8 [432, 256], sv float32 [256], wb float32 [10, 256]). wq is the
    im2col weight with the normalize scale folded in, quantized per output
    column (scale sw); sv = sw * BN scale; wb rows 0-8 are each tap's share
    of the normalize bias and the +128 (sum over its 48 channels of
    weight x normalize(128)), BN-scaled, and row 9 is the BN bias."""
    dev = w7.device
    a3, b3 = affine_consts(dev)
    a48 = a3.repeat(16)
    bp48 = a48 * 128.0 + b3.repeat(16)  # normalize(128) per s2d channel
    w2 = stem_weight_im2col(w7)
    wq, sw = quantize_weight(w2 * a48.repeat(9)[:, None])
    s_bn = scale.to(device=dev, dtype=torch.float32).reshape(64).repeat(4)
    b_bn = bias.to(device=dev, dtype=torch.float32).reshape(64).repeat(4)
    wb9 = torch.einsum("tkc,k->tc", w2.reshape(9, 48, 256), bp48) * s_bn
    return wq, sw * s_bn, torch.cat([wb9, b_bn[None]])


def stem_s2d_int8_plain(s4: torch.Tensor, wq: torch.Tensor, sv: torch.Tensor,
                        wb: torch.Tensor,
                        out_dtype: torch.dtype = torch.bfloat16
                        ) -> torch.Tensor:
    """Plain version of K14b (_stem_kernel_i8, stem_pallas.py:339) on
    stem_int8_weights: z = the 3x3 cell neighbourhood of s4 - 128 (zero
    outside the frame), acc = z @ wq exactly (float64), bias = the wb rows
    of the taps inside the frame added in tap order from 0, then wb[9];
    y = relu(f32(acc) * sv + bias) in out_dtype, then the 3x3/2 max pool
    of the conv output (2I+pr, 2J+pc). s4 [N, h, w, 48] uint8 ->
    [N, h, w, 64]."""
    n, hs, ws, _ = s4.shape
    xp = F.pad(s4.double() - 128.0, (0, 0, 1, 1, 1, 1))
    z = torch.cat([xp[:, tr:tr + hs, tc:tc + ws]
                   for tr in range(3) for tc in range(3)], dim=-1)
    acc = _idot(z, wq)
    ii = torch.arange(hs, device=s4.device)[:, None]
    jj = torch.arange(ws, device=s4.device)[None, :]
    bias = torch.zeros(hs, ws, 256, device=s4.device)
    for t in range(9):
        r, c = ii - 1 + t // 3, jj - 1 + t % 3
        inside = ((r >= 0) & (r < hs) & (c >= 0) & (c < ws))[..., None]
        bias = torch.where(inside, bias + wb[t], bias)
    bias = bias + wb[9]
    y = torch.relu(acc * sv + bias).to(out_dtype)
    conv = y.reshape(n, hs, ws, 2, 2, 64).permute(0, 1, 3, 2, 4, 5)
    conv = conv.reshape(n, 2 * hs, 2 * ws, 64)
    pooled = F.max_pool2d(conv.permute(0, 3, 1, 2), 3, stride=2, padding=1)
    return pooled.permute(0, 2, 3, 1).contiguous()


def stem_s2d_int8(s4: torch.Tensor, w7: torch.Tensor, scale: torch.Tensor,
                  bias: torch.Tensor,
                  out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Weight-only int8 stem, s4 [N, h, w, 48] uint8 raw pixels ->
    [N, h, w, 64]; w7 [7, 7, 3, 64] (HWIO), scale/bias [64] the folded BN:
    stem_int8_weights, then stem_int8."""
    return stem_int8(s4, stem_int8_weights(w7.to(s4.device), scale, bias),
                     out_dtype)


def _int8_weight(wq: torch.Tensor, sv: torch.Tensor, wb: torch.Tensor):
    """K14b's weights from stem_int8_weights: (wt int8 [256, 512] = wq^T,
    K zero-padded 432 -> 512 (four 128-byte rows a filter column), sv, wb
    as contiguous float32). Kept for the last (wq, sv, wb) seen (the same
    tensors at the same versions), as _phase_weight keeps its weight."""
    key = tuple((t._version, t.dtype, t.device) for t in (wq, sv, wb))
    last = _int8_weight.last
    if (last is not None and all(r() is t for r, t in zip(last[0],
                                                         (wq, sv, wb)))
            and last[1] == key):
        return last[2]
    wt = torch.zeros(256, 512, dtype=torch.int8, device=wq.device)
    wt[:, :432] = wq.t()
    made = (wt, sv.float().contiguous(), wb.float().contiguous())
    _int8_weight.last = (tuple(weakref.ref(t) for t in (wq, sv, wb)), key,
                         made)
    return made


_int8_weight.last = None


def stem_int8(s4: torch.Tensor, weights, out_dtype=torch.bfloat16
              ) -> torch.Tensor:
    """stem_s2d_int8 on weights made ahead, (wq, sv, wb) of
    stem_int8_weights. On a CUDA tensor one launch of vcg_stem_s2d_int8
    (bfloat16 out, no scratch), counted in stem_s2d_int8.launches."""
    if s4.dtype != torch.uint8 or s4.dim() != 4 or s4.shape[-1] != 48:
        raise ValueError(f"stem_s2d_int8 takes uint8 [N,h,w,48], got "
                         f"{s4.dtype} {tuple(s4.shape)}")
    wq, sv, wb = weights
    if s4.device.type == "cpu":
        return stem_s2d_int8_plain(s4, wq, sv, wb, out_dtype)
    if s4.device.type != "cuda":
        raise NotImplementedError(f"stem_s2d_int8 on {s4.device}")
    if out_dtype != torch.bfloat16:
        raise ValueError("the int8 stem kernel emits bfloat16")
    if not s4.is_contiguous() or s4.data_ptr() % 16:
        raise ValueError("stem_s2d_int8 takes a contiguous, 16-byte aligned "
                         "s2d pack")
    if (tuple(wq.shape) != (432, 256) or wq.dtype != torch.int8
            or any(t.device != s4.device for t in weights)):
        raise ValueError("stem_int8 takes stem_int8_weights on s4's device")
    n, h, w, _ = s4.shape
    dev = s4.device
    wt, sv, wb = _int8_weight(wq, sv, wb)
    out = torch.empty(n, h, w, 64, dtype=torch.bfloat16, device=dev)
    rc = _calls.on_device(
        _lib("vcg_stem_s2d_int8"), dev, s4.data_ptr(), wt.data_ptr(),
        sv.data_ptr(), wb.data_ptr(), out.data_ptr(), n, h, w,
        walk_bands(dev, n, h, w))
    _calls.count(stem_s2d_int8)
    if rc != 0:
        raise RuntimeError(f"stem_s2d_int8 kernel launch failed: CUDA error "
                           f"{rc}")
    return out


stem_s2d.launches = 0
stem_s2d_int8.launches = 0
stem_frames.launches = 0
bn_relu_maxpool.launches = 0
