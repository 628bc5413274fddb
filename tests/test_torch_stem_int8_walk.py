"""The int8 stem kernel's epilogue (K14b) in plain torch, on the CPU.

csrc/stem_s2d.cu runs K14b on K1's strip walk (csrc/stem_tiles.cuh:
stem_i8_kernel): per strip of 2 cell rows (a frame wider than 64 cells in
column chunks), one s8 product over the 3x3 cell neighbourhood of x - 128
(zero cells outside the frame), then per phase y = bf16(relu(f32(acc) *
sv + bias)) with the bias of the cell's validity class (which tap rows and
tap columns lie inside the frame; the class rows are made once a block,
adding the valid taps' wb rows in tap order from 0, then wb[9]), then the
3x3/2 max pool of the y by K1's column pool, left-neighbour and carried
row. `int8_stem_walk` below is that decomposition; here it is held bit
for bit (bf16) to the port's plain version `stem_s2d_int8_plain`, and in
float32 to the JAX stem_s2d_int8_pallas in interpret mode within the
tolerance of tests/test_torch_int8_s2.py (1e-5 of the largest magnitude:
the JAX kernel adds its bias rows by a dot), on frames of 1 and 2 cell
rows and columns (a cell of several classes at once), non-square frames,
tiles of 3-4 cells and every band split.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch
import torch.nn.functional as F

from test_torch_stem_phase import chunk_spans
from video_chapter_generation_tpu.ops.stem_pallas import stem_s2d_int8_pallas
from video_chapter_generation_tpu_torch.ops.stem import (
    STEM_TILE_CELLS,
    stem_int8_weights,
    stem_s2d_int8_plain,
)
from video_chapter_generation_tpu_torch.ops.tsm_block_int8 import _idot


def class_slot(i: int, n: int) -> int:
    """csrc/stem_tiles.cuh:class_slot: bit 0 where tap 0 of coordinate i
    lies outside (i == 0), bit 1 where tap 2 does (i == n - 1); class 3
    (n == 1) takes slot 0."""
    c = (i == 0) | ((i == n - 1) << 1)
    return 0 if c == 3 else c


def class_rows(wb: torch.Tensor, hs: int, ws: int) -> torch.Tensor:
    """The 3 x 3 class rows [9, 256] float32, each the valid taps' wb rows
    added in tap order from 0, then wb[9]."""
    rows = []
    for slot in range(9):
        rc = 3 if hs == 1 else slot // 3
        cc = 3 if ws == 1 else slot % 3
        bias = torch.zeros(256, dtype=torch.float32)
        for tap in range(9):
            tr, tc = divmod(tap, 3)
            if (tr == 0 and rc & 1) or (tr == 2 and rc & 2) or \
                    (tc == 0 and cc & 1) or (tc == 2 and cc & 2):
                continue
            bias = bias + wb[tap]
        rows.append(bias + wb[9])
    return torch.stack(rows)


def int8_stem_walk(s4: torch.Tensor, wq, sv, wb, bands: int,
                   out_dtype=torch.bfloat16, tile=STEM_TILE_CELLS):
    """K14b's decomposition: s4 [N, hs, ws, 48] uint8 -> [N, hs, ws, 64]
    out_dtype, over frames, column chunks (with the pool's extra cell)
    and bands of strips as the kernel walks them."""
    n, hs, ws, _ = s4.shape
    z = F.pad(s4.double() - 128.0, (0, 0, 1, 1, 1, 1))
    table = class_rows(wb.float(), hs, ws)
    sv = sv.float()
    out = torch.full((n, hs, ws, 64), float("nan"), dtype=out_dtype)
    strips = (hs + 1) // 2
    lost = float("-inf")
    for fr in range(n):
        for c0, cb, c1 in chunk_spans(ws, tile):
            wt = c1 - cb
            for band in range(bands):
                lo, hi = band * strips // bands, (band + 1) * strips // bands
                carry = None
                for s in range(lo - 1 if lo > 0 else lo, hi):
                    rows = min(2, hs - 2 * s)
                    nbh = z[fr, 2 * s:2 * s + rows + 2, cb:c1 + 2]
                    a = torch.cat([nbh[tr:tr + rows, tc:tc + wt]
                                   for tr in range(3) for tc in range(3)], -1)
                    acc = _idot(a, wq.double())  # [rows, wt, 256] float32
                    slots = torch.tensor(
                        [[3 * class_slot(2 * s + lr, hs)
                          + class_slot(cb + j, ws) for j in range(wt)]
                         for lr in range(rows)])
                    y = torch.relu(acc * sv + table[slots]).to(out_dtype)
                    y = y.float().reshape(rows, wt, 2, 2, 64)  # (pr, pc, f)
                    left = F.pad(y[:, :-1, :, 1], (0, 0, 0, 0, 1, 0),
                                 value=lost)
                    cp = torch.maximum(y.amax(dim=3), left)
                    up = torch.full_like(cp[:, :, 1], lost)
                    if carry is not None:
                        up[0] = carry
                    up[1:] = cp[:-1, :, 1]
                    if s >= lo:
                        pool = torch.maximum(cp.amax(dim=2), up)
                        out[fr, 2 * s:2 * s + rows, c0:c1] = pool[
                            :, c0 - cb:].to(out_dtype)
                    carry = cp[-1, :, 1]
    return out


def _weights(seed):
    rng = np.random.default_rng(seed)
    w7 = (rng.normal(size=(7, 7, 3, 64)) * 0.05).astype(np.float32)
    scale = (rng.normal(size=64) * 0.1 + 1.0).astype(np.float32)
    scale[::5] *= -1  # a negative BN scale: its sv column is negative
    bias = (rng.normal(size=64) * 0.1).astype(np.float32)
    return w7, scale, bias


# (frames, hs, ws, tile cells): 1 and 2 cell rows and columns (one cell of
# 2-4 validity classes), non-square, column chunks of 3-4 cells
SHAPES = [(2, 1, 1, 64), (2, 1, 2, 64), (2, 2, 1, 64), (2, 2, 2, 64),
          (1, 2, 7, 3), (2, 5, 3, 64), (1, 9, 9, 4)]


@pytest.mark.parametrize("n,hs,ws,tile", SHAPES)
def test_int8_stem_walk_is_the_plain_version(n, hs, ws, tile):
    """Bit for bit in bf16, for every band split."""
    w7, scale, bias = _weights(hs * 10 + ws)
    s4 = torch.from_numpy(np.random.default_rng(ws).integers(
        0, 256, (n, hs, ws, 48)).astype(np.uint8))
    weights = stem_int8_weights(*[torch.from_numpy(a)
                                  for a in (w7, scale, bias)])
    want = stem_s2d_int8_plain(s4, *weights)
    for bands in range(1, (hs + 1) // 2 + 1):
        got = int8_stem_walk(s4, *weights, bands, tile=tile)
        assert torch.equal(got, want), bands


@pytest.mark.parametrize("px,tile,bands", [(4, 64, 1), (8, 64, 1),
                                           (12, 64, 2), (36, 4, 3)])
def test_int8_stem_walk_matches_jax(px, tile, bands):
    """float32 against the JAX kernel on square frames (what it takes)."""
    w7, scale, bias = _weights(px)
    s4 = np.random.default_rng(px + 1).integers(
        0, 256, (2, px // 4, px // 4, 48)).astype(np.uint8)
    want = np.asarray(stem_s2d_int8_pallas(
        jnp.asarray(s4), jnp.asarray(w7), jnp.asarray(scale),
        jnp.asarray(bias), out_dtype=jnp.float32))
    weights = stem_int8_weights(*[torch.from_numpy(a)
                                  for a in (w7, scale, bias)])
    got = int8_stem_walk(torch.from_numpy(s4), *weights, bands,
                         torch.float32, tile)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    assert (want > 0).mean() > 0.2  # the ReLU leaves a real signal


def test_class_rows_cover_every_cell():
    """Each cell's class row equals the bias the plain version adds for it
    (the valid taps' rows in tap order, then wb[9]), at 1-3 cells a side."""
    wb = torch.from_numpy(np.random.default_rng(5).normal(
        size=(10, 256)).astype(np.float32))
    for hs in (1, 2, 3):
        for ws in (1, 2, 3):
            table = class_rows(wb, hs, ws)
            for i in range(hs):
                for j in range(ws):
                    want = torch.zeros(256)
                    for t in range(9):
                        r, c = i - 1 + t // 3, j - 1 + t % 3
                        if 0 <= r < hs and 0 <= c < ws:
                            want = want + wb[t]
                    want = want + wb[9]
                    got = table[3 * class_slot(i, hs) + class_slot(j, ws)]
                    assert torch.equal(got, want), (hs, ws, i, j)
