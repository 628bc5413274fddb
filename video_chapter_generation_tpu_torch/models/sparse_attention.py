"""Block-sparse (BigBird ITC) attention (counterpart of the JAX package's
models/sparse_attention.py).

The layout is HF BigBirdPegasus's: query blocks 0 and nb-1 attend the
whole sequence; key blocks 0 and nb-1 are global; middle query block qi
attends {0, qi-1, qi, qi+1, nb-1} plus num_rand_blocks random blocks
from a static seed-derived map shared across heads and layers; padding
enters as an additive -10000 on the scaled scores, and padded query rows
are zeroed on the sparse path. The middle blocks take one of two routes
(`impl`, JAX :95-99, 150-155): "kernel" is
ops/sparse_attention.py:sparse_band_attention (kernel K10 on a CUDA
tensor, its plain version on a CPU one), which has no backward, as the
Pallas kernel has none: it raises NotImplementedError where q, k or v
need a gradient; "gather" is the JAX model's gather formulation (JAX
:174-196: the attended key and value blocks gathered per query block,
the deterministic ones deduplicated, one batched attention), which
autograd differentiates; "auto" takes the kernel where no gradient is
needed (eval, serving) and the gather formulation where one is
(training). The first and last blocks, and short sequences, are plain
matmuls with a float32 softmax, as XLA computed them outside the TPU
kernel.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.sparse_attention import (
    MASK_PENALTY,
    sparse_band_attention,
    structured_ids,
)


def _random_block_map(n_blocks: int, num_rand: int, seed: int) -> np.ndarray:
    """[n_blocks, num_rand] static random attended-block indices, excluding
    each query block's own window and the global first/last blocks
    (models/sparse_attention.py:47-62 of the JAX package, verbatim: numpy's
    default_rng(seed).choice and np.resize give the same map)."""
    rng = np.random.default_rng(seed)
    out = np.zeros((n_blocks, max(num_rand, 0)), np.int32)
    for qb in range(n_blocks):
        banned = {0, qb - 1, qb, qb + 1, n_blocks - 1}
        candidates = [b for b in range(n_blocks) if b not in banned]
        if not candidates:
            candidates = [qb]
        pick = rng.choice(
            candidates, size=min(num_rand, len(candidates)), replace=False
        )
        row = np.resize(pick, num_rand) if num_rand else pick
        out[qb] = row
    return out


SPARSE_IMPLS = ("auto", "gather", "kernel")

_tables_cache: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def _tables(nb: int, num_rand: int, seed: int, rand_map, device):
    """(ids, valid) int32 [nb-2, 5 + r] on `device`. The seeded tables are
    made once per shape and device (every layer of an encode shares
    them); an injected rand_map builds its own."""
    key = (nb, num_rand, seed, str(device))
    if rand_map is None and key in _tables_cache:
        return _tables_cache[key]
    injected = rand_map is not None
    if injected:
        rand_map = np.asarray(rand_map, np.int32)
    elif num_rand > 0:
        rand_map = _random_block_map(nb, num_rand, seed)
    tables = tuple(torch.from_numpy(a).to(device)
                   for a in structured_ids(nb, rand_map))
    if not injected:
        _tables_cache[key] = tables
    return tables


def gather_ids(nb: int, rand_map: Optional[np.ndarray]
               ) -> Tuple[np.ndarray, np.ndarray]:
    """The gather formulation's attended blocks for query blocks 1..nb-2
    (JAX models/sparse_attention.py:129-148): ids [nb-2, 5 + r] int32,
    the deterministic blocks {0, qi-1, qi, qi+1, nb-1} deduplicated in
    order, then the random blocks verbatim, padded with the first id;
    valid [nb-2, 5 + r] int32, 0 on the padding."""
    n_att = 5 + (0 if rand_map is None else rand_map.shape[1])
    rows, valids = [], []
    for qb in range(1, nb - 1):
        ids = list(dict.fromkeys([0, qb - 1, qb, qb + 1, nb - 1]))
        if rand_map is not None:
            ids += [int(r) for r in rand_map[qb]]
        valids.append([1] * len(ids) + [0] * (n_att - len(ids)))
        rows.append(ids + [ids[0]] * (n_att - len(ids)))
    return np.asarray(rows, np.int32), np.asarray(valids, np.int32)


def _gather_attention(q, k, v, mask, ids, valid, bs: int, scale: float):
    """The middle query blocks by the gather formulation (JAX
    :176-193): q, k, v [B, L, H, hd], mask [B, L], ids and valid [nb-2,
    P] long tensors -> [B, (nb-2)*bs, H, hd] in q's dtype; scores and
    softmax in at least float32."""
    b, l, h, hd = q.shape
    nb, p = l // bs, ids.shape[1]
    kg = k.reshape(b, nb, bs, h, hd)[:, ids].reshape(b, nb - 2, p * bs, h, hd)
    vg = v.reshape(b, nb, bs, h, hd)[:, ids].reshape(b, nb - 2, p * bs, h, hd)
    mg = mask.reshape(b, nb, bs)[:, ids] * valid[None, :, :, None]
    qs = q.reshape(b, nb, bs, h, hd)[:, 1:-1]
    att = torch.einsum("bnqhd,bnkhd->bnhqk", qs, kg)
    att = att.to(torch.promote_types(att.dtype, torch.float32)) * scale
    pen = (1.0 - mg.reshape(b, nb - 2, p * bs).to(att.dtype)) * MASK_PENALTY
    att = torch.softmax(att + pen[:, :, None, None, :], dim=-1).to(q.dtype)
    out = torch.einsum("bnhqk,bnkhd->bnqhd", att, vg)
    return out.reshape(b, (nb - 2) * bs, h, hd)


def _full_attention(q, k, v, mask, scale: float):
    """q [B, Q, H, hd] over all of k, v [B, L, H, hd]; scores and softmax
    in at least float32 with the -10000 key penalty; the result in q's
    dtype."""
    att = torch.einsum("bqhd,bkhd->bhqk", q, k)
    att = att.to(torch.promote_types(att.dtype, torch.float32)) * scale
    att = att + (1.0 - mask[:, None, None, :].to(att.dtype)) * MASK_PENALTY
    att = torch.softmax(att, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", att, v)


def block_sparse_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mask: Optional[torch.Tensor], block_size: int = 64,
                           num_rand_blocks: int = 2,
                           num_global_blocks: int = 1, seed: int = 0,
                           rand_map: Optional[np.ndarray] = None,
                           impl: str = "auto") -> torch.Tensor:
    """q, k, v [B, L, H, hd]; mask [B, L] (1 keep / 0 pad) or None ->
    [B, L, H, hd]. L must be a multiple of block_size. rand_map: optional
    [nb, num_rand_blocks] override of the random blocks per query block
    (rows 0 and nb-1 unused); the default is _random_block_map(nb, r,
    seed). Only one global block at each end is supported, as in HF.
    impl: "auto", "gather" or "kernel" (see the module docstring)."""
    if impl not in SPARSE_IMPLS:
        raise ValueError(f"impl {impl!r}: one of {SPARSE_IMPLS}")
    if num_global_blocks != 1:
        raise ValueError("the BigBird ITC layout has exactly one global block "
                         f"at each end (got num_global_blocks="
                         f"{num_global_blocks})")
    b, l, h, hd = q.shape
    bs = block_size
    if l % bs:
        raise ValueError(f"sequence length {l} is not a multiple of the "
                         f"block size {bs}")
    nb = l // bs
    scale = 1.0 / math.sqrt(hd)
    if mask is None:
        mask = torch.ones(b, l, dtype=torch.int32, device=q.device)
    # HF falls back to full attention when band + globals + random blocks
    # would cover the row; padded query rows are then NOT zeroed
    if nb <= 5 + 2 * num_rand_blocks:
        return _full_attention(q, k, v, mask, scale)

    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    if impl == "kernel" and needs_grad:
        raise NotImplementedError(
            "the block-sparse attention kernel has no backward (nor has "
            "the JAX package's Pallas kernel): train with impl 'gather' "
            "or 'auto'")
    if impl == "gather" or (impl == "auto" and needs_grad):
        if rand_map is None and num_rand_blocks > 0:
            rand_map = _random_block_map(nb, num_rand_blocks, seed)
        ids, valid = (torch.from_numpy(a).to(q.device)
                      for a in gather_ids(nb, None if rand_map is None
                                          else np.asarray(rand_map)))
        mid = _gather_attention(q, k, v, mask, ids.long(), valid, bs, scale)
        out = torch.cat([_full_attention(q[:, :bs], k, v, mask, scale), mid,
                         _full_attention(q[:, l - bs:], k, v, mask, scale)],
                        dim=1)
    else:
        ids, valid = _tables(nb, num_rand_blocks, seed, rand_map, q.device)
        out = torch.empty_like(q)
        sparse_band_attention(q[:, bs:l - bs], k, v, mask, ids, valid, bs,
                              out)
        out[:, :bs] = _full_attention(q[:, :bs], k, v, mask, scale)
        out[:, l - bs:] = _full_attention(q[:, l - bs:], k, v, mask, scale)
    # HF zeroes padded query rows (context_layer * from_mask)
    return out * mask[:, :, None, None].to(out.dtype)
