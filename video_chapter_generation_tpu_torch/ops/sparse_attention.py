"""BigBird block-sparse attention of the middle query blocks (kernel K10).

`sparse_band_attention` replaces the JAX package's
ops/sparse_attention_pallas.py:sparse_band_attention_pallas (:108). For
every (batch, head, query block qi in 1..nb-2) it attends the P key
blocks of the structured table `structured_ids` ([gfirst, qi-1, qi,
qi+1, glast, rand...]) read straight from the full k and v, with key
padding and the table's valid flags entering as an additive
(1 - mask * valid) * -10000 on the scaled float32 scores, a float32
softmax and the value product. It runs csrc/sparse_attention.cu on a
CUDA tensor, on one of three kernels: the serving kernel (wgmma) at bs
64, hd 64 and 8 parts (BigBird-Pegasus), which walks consecutive query
blocks of a (batch, head) and keeps their shared key/value blocks
resident; at every other shape (bs 16-64, hd 16-128, any part count, any
table: `--tiny --title_arch bigbird` and every other BigBird
configuration) the faster of the ring kernel (wgmma, each query block's
parts streamed through a ring of TMA slots) and the mma.sync kernel (one
block a query block) at the shape's class, as `--time-kernels` measured
them (`_route`);
`sparse_band_attention_reference` is the plain version, and a CPU tensor
takes it.

The TPU kernel's penalty table replicated over 8 sublanes
(sparse_attention_pallas.py:67-78) exists only for Mosaic's (8, 128)
tiling; here the kernel reads the [B, L] mask and the [nbq, P] id and
valid tables itself.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from . import _build, _calls

MASK_PENALTY = -10000.0
MAX_BLOCK, MAX_HEAD_DIM = 64, 128


def structured_ids(nb: int, rand_map: Optional[np.ndarray]
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Attended-block table in structured slot order for query blocks
    1..nb-2 (sparse_attention_pallas.py:46-64): ids [nbq, P] int32 with
    rows [0, qi-1, qi, qi+1, nb-1, rand...], and valid [nbq, P] int32 with
    0 on the global slot that the band already covers (row 1's gfirst,
    row nb-2's glast). Random blocks are taken verbatim: a random block
    that collides with the window is counted twice, as HF does."""
    nbq = nb - 2
    r = 0 if rand_map is None else rand_map.shape[1]
    ids = np.zeros((nbq, 5 + r), np.int32)
    valid = np.ones((nbq, 5 + r), np.int32)
    for i in range(nbq):
        qi = i + 1
        ids[i, :5] = [0, qi - 1, qi, qi + 1, nb - 1]
        if qi == 1:
            valid[i, 0] = 0
        if qi == nb - 2:
            valid[i, 4] = 0
        if r:
            ids[i, 5:] = rand_map[qi]
    return ids, valid


def sparse_band_attention_reference(q_mid, k, v, mask, ids, valid,
                                    block_size: int):
    """Plain version. q_mid [B, nbq*bs, H, hd] (query blocks 1..nb-2),
    k, v [B, L, H, hd], mask [B, L] (1 keep, 0 pad), ids and valid
    [nbq, P] integer tensors. The P key/value blocks of each query block
    are concatenated, scores are float32 times 1/sqrt(hd) plus the
    penalty, then softmax and the value product in float32; the result
    [B, nbq*bs, H, hd] is in q's dtype."""
    b, lq, h, hd = q_mid.shape
    bs = block_size
    nbq, p = ids.shape
    nb = k.shape[1] // bs
    ids = ids.long().to(q_mid.device)
    valid = valid.to(q_mid.device)
    kg = k.reshape(b, nb, bs, h, hd)[:, ids].reshape(b, nbq, p * bs, h, hd)
    vg = v.reshape(b, nb, bs, h, hd)[:, ids].reshape(b, nbq, p * bs, h, hd)
    mg = mask.reshape(b, nb, bs)[:, ids].float() * valid[None, :, :, None]
    pen = (1.0 - mg.reshape(b, nbq, p * bs)) * MASK_PENALTY
    qs = q_mid.reshape(b, nbq, bs, h, hd).float()
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bnqhd,bnkhd->bnhqk", qs, kg.float()) * scale
    s = torch.softmax(s + pen[:, :, None, None, :], dim=-1)
    out = torch.einsum("bnhqk,bnkhd->bnqhd", s, vg.float())
    return out.reshape(b, lq, h, hd).to(q_mid.dtype)


def _lib():
    fn = _build.load("sparse_attention").vcg_sparse_band_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 2 + [ctypes.c_int,
                                                    ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


# the kernels, by the route number csrc/sparse_attention.cu gives them
ROUTES = ("serving", "ring", "mma_sync")


@functools.lru_cache(maxsize=None)
def _route(bs: int, hd: int, np_: int, nbq: int) -> int:
    """The kernel (an index into ROUTES) that a call at this shape runs;
    the C side decides, so the two never disagree."""
    fn = _build.load("sparse_attention").vcg_sparse_band_route
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 4
        fn.restype = ctypes.c_int
    return fn(bs, hd, np_, nbq)


# tables found structured: id(ids) -> (ids, its version); the tensor is
# held so that its id is not reused while the entry lives
_structured_seen: dict = {}


def require_structured(ids: torch.Tensor, nb: int) -> None:
    """Raise ValueError unless ids[:, :5] are structured_ids(nb)'s
    [0, qi-1, qi, qi+1, nb-1] rows, which the serving kernel derives from
    the structure instead of reading. A table is compared once (one sync)
    and remembered while it is not written to."""
    seen = _structured_seen.get(id(ids))
    if seen is not None and seen[0] is ids and seen[1] == ids._version:
        return
    nbq = nb - 2
    qi = torch.arange(1, nbq + 1, dtype=torch.int32, device=ids.device)
    want = torch.stack([torch.zeros_like(qi), qi - 1, qi, qi + 1,
                        torch.full_like(qi, nb - 1)], 1)
    if tuple(ids.shape[:1]) != (nbq,) or ids.shape[1] < 5 \
            or not torch.equal(ids[:, :5], want):
        raise ValueError("ids[:, :5] must be structured_ids' [0, qi-1, qi, "
                         "qi+1, nb-1] rows at this shape")
    if len(_structured_seen) >= 8:
        _structured_seen.pop(next(iter(_structured_seen)))
    _structured_seen[id(ids)] = (ids, ids._version)


def _check(q_mid, k, v, mask, ids, valid, bs, out):
    b, lq, h, hd = q_mid.shape
    l = k.shape[1]
    bf = torch.bfloat16
    if not (bs % 16 == 0 and 16 <= bs <= MAX_BLOCK and hd % 16 == 0
            and 16 <= hd <= MAX_HEAD_DIM):
        raise ValueError(f"sparse_band_attention takes block sizes 16..64 and "
                         f"head dims 16..128, multiples of 16; got bs={bs} "
                         f"hd={hd}")
    if l % bs or lq != l - 2 * bs:
        raise ValueError(f"q_mid holds {lq} rows, not L - 2*bs for L={l}, "
                         f"bs={bs}")
    for name, t in (("q_mid", q_mid), ("k", k), ("v", v)):
        if t.dtype != bf or t.device != k.device:
            raise ValueError(f"{name} must be bf16 on {k.device}, got "
                             f"{t.dtype} on {t.device}")
    if tuple(k.shape) != (b, l, h, hd) or tuple(v.shape) != (b, l, h, hd) \
            or not (k.is_contiguous() and v.is_contiguous()):
        raise ValueError("k and v must be contiguous [B, L, H, hd]")
    # q_mid may be a row slice of a contiguous [B, L, H, hd] tensor
    if q_mid.stride()[1:] != (h * hd, hd, 1):
        raise ValueError("q_mid must have contiguous [H, hd] rows")
    nbq = l // bs - 2
    if ids.shape != valid.shape or ids.shape[0] != nbq or ids.shape[1] < 5:
        raise ValueError(f"ids/valid must be [{nbq}, P>=5], got "
                         f"{tuple(ids.shape)} / {tuple(valid.shape)}")
    for name, t in (("ids", ids), ("valid", valid)):
        if t.dtype != torch.int32 or t.device != k.device \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32 on {k.device}")
    if tuple(mask.shape) != (b, l) or mask.device != k.device:
        raise ValueError(f"mask must be [{b}, {l}] on {k.device}")
    if (tuple(out.shape) != (b, l, h, hd) or out.dtype != bf
            or not out.is_contiguous() or out.device != k.device):
        raise ValueError("out must be contiguous bf16 [B, L, H, hd]")


def sparse_band_attention(q_mid, k, v, mask, ids, valid, block_size: int,
                          out: torch.Tensor) -> torch.Tensor:
    """The middle query blocks' block-sparse attention (see
    sparse_band_attention_reference for the arguments), written into rows
    bs..L-bs of `out` ([B, L, H, hd], q's dtype); returns that slice. The
    caller fills the first and last blocks beside it, so no concatenation
    follows. On a CUDA tensor: bf16 only, bs and hd multiples of 16 up to
    64 and 128, a 0/1 mask. bs 64, hd 64 and 8 parts (the BigBird-Pegasus
    serving shape) run the serving kernel, which derives parts 0-4 from
    the structure (a table whose ids[:, :5] are not structured_ids'
    raises ValueError); every other shape runs the ring or the mma.sync
    kernel (`_route`), which read every id. Each launch counts in
    `launches` and in its kernel's `serving_launches`, `ring_launches` or
    `mma_sync_launches`. The kernels have no backward: a CUDA input that
    requires a gradient raises NotImplementedError (the models' gather
    formulation trains)."""
    bs = block_size
    l = k.shape[1]
    if q_mid.device.type == "cpu":
        out[:, bs:l - bs] = sparse_band_attention_reference(
            q_mid, k, v, mask, ids, valid, bs)
        return out[:, bs:l - bs]
    if q_mid.device.type != "cuda":
        raise NotImplementedError(f"sparse_band_attention on {q_mid.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q_mid, k,
                                                                  v)):
        raise NotImplementedError(
            "sparse_band_attention has no backward: its kernel writes the "
            "output through a pointer, which autograd cannot see")
    _check(q_mid, k, v, mask, ids, valid, bs, out)
    route = _route(bs, q_mid.shape[3], ids.shape[1], l // bs - 2)
    return _launch(q_mid, k, v, mask, ids, valid, bs, out, route)


def _launch(q_mid, k, v, mask, ids, valid, bs, out, route: int):
    """Launch kernel ROUTES[route] on checked CUDA arguments and count it.
    sparse_band_attention passes the shape's own route; a timing may pass
    another (the serving kernel only where it applies)."""
    l = k.shape[1]
    h, hd = q_mid.shape[2:]
    if route == 0:
        require_structured(ids, l // bs)
    mask_i = mask.to(torch.int32).contiguous()  # a 0/1 mask: exact
    if mask_i.data_ptr() % 16:  # the ring kernel bulk-copies its rows
        mask_i = mask_i.clone()
    rc = _calls.on_device(
        _lib(), q_mid.device, q_mid.data_ptr(), k.data_ptr(), v.data_ptr(),
        mask_i.data_ptr(), ids.data_ptr(), valid.data_ptr(),
        out.data_ptr() + bs * h * hd * out.element_size(),
        k.shape[0], l, h, hd, bs, ids.shape[1], q_mid.stride(0), l * h * hd,
        route)
    _calls.count(sparse_band_attention)
    _calls.count(sparse_band_attention, f"{ROUTES[route]}_launches")
    if rc != 0:
        raise RuntimeError(f"sparse_band_attention kernel failed: CUDA error "
                           f"{rc}")
    return out[:, bs:l - bs]


sparse_band_attention.launches = 0
sparse_band_attention.serving_launches = 0
sparse_band_attention.ring_launches = 0
sparse_band_attention.mma_sync_launches = 0
