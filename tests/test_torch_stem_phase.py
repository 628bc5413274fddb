"""The stem kernel's decomposition (K1, K8) in plain torch, on the CPU.

csrc/stem_s2d.cu computes the stem as one phase-packed product per strip
of 2 cell rows and pools in its epilogue, with the cell row above a strip
carried from the strip before and recomputed where a band of strips
starts below the frame's top; a frame row wider than a tile's 64 cells
is walked in column chunks, each tile also computing the cell left of
its chunk (the left neighbour of the chunk's first pool window), which it
stores nowhere. stem_phase_plain below is that decomposition in plain
torch, with the tile width as a parameter; here it is held, in float32 on
the same numpy inputs, to the port's plain stems and to the JAX Pallas
kernel in interpret mode, for every band split of the frame and for
tiles of 3 and 4 cells (chunk seams at 32-48 px), so the halo, carry and
seam index logic is checked without a card. Tolerance 1e-4 absolute and
relative: the sums run in other orders (as tests/test_torch_ops.py).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch
import torch.nn.functional as F

from video_chapter_generation_tpu.ops.stem_pallas import stem_s2d_pallas
from video_chapter_generation_tpu_torch.ops.preprocess import (
    depth_to_space4,
    normalize_frames_reference,
)
from video_chapter_generation_tpu_torch.ops.stem import (
    STEM_TILE_CELLS,
    stem_bands,
    stem_chunks,
    stem_frames_reference,
    stem_s2d_reference,
    stem_weight_im2col,
)

TOL = dict(rtol=1e-4, atol=1e-4)


def chunk_spans(ws: int, tile: int = STEM_TILE_CELLS, overlap: bool = True):
    """The column chunks of a frame row of ws cells for tiles of at most
    `tile` cells (csrc/stem_tiles.cuh:stem_chunks, stem_tile): [(c0, cb,
    c1)], output cells [c0, c1) computed from cb, one cell to the left of
    c0 after the first chunk where overlap (the pool)."""
    chunks = 1 if ws <= tile else -(-ws // (tile - 1))
    spans = []
    for k in range(chunks):
        c0, c1 = k * ws // chunks, (k + 1) * ws // chunks
        spans.append((c0, c0 - 1 if overlap and k > 0 else c0, c1))
    return spans


def stem_phase_plain(cells: torch.Tensor, w7: torch.Tensor,
                     scale: torch.Tensor, bias: torch.Tensor, bands: int,
                     out_dtype: torch.dtype = torch.float32,
                     tile: int = STEM_TILE_CELLS) -> torch.Tensor:
    """The stem kernel's own decomposition in plain torch, for testing its
    index logic: cells [N, hs, ws, 48] normalized s2d cells (channel
    (dy, dx, c)) -> [N, hs, ws, 64]. Per frame, per column chunk
    (chunk_spans), per band of strips (as csrc/stem_s2d.cu splits them):
    each strip of 2 cell rows of the chunk is one phase-packed product
    over the 3x3 cell neighbourhood (real cells across a chunk seam, zero
    cells outside the frame), rounded to out_dtype and negated where the
    BN scale is negative (t); the column pool takes both column phases of
    a cell and column phase 1 of the cell to its left (none for the
    tile's first column: the frame's edge, or the extra cell of a chunk
    after the first, which is stored nowhere); the pool takes the two row
    phases' column pools and row phase 1 of the cell row above, carried
    from the strip before (a band that starts below the top first
    recomputes the strip above it for that row and stores nothing from
    it); then the affine, ReLU and rounding, which are monotone in t, so
    pooling first gives the pool of the activations."""
    n, hs, ws, _ = cells.shape
    dt = out_dtype
    w2 = stem_weight_im2col(w7).to(cells.dtype)
    sgn = torch.where(scale.float() < 0, -1.0, 1.0)
    padded = F.pad(cells, (0, 0, 1, 1, 1, 1))
    out = torch.full((n, hs, ws, 64), float("nan"), dtype=dt,
                     device=cells.device)
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
                    # cell rows 2s - 1 .., columns cb - 1 .. c1 (padded)
                    nbh = padded[fr, 2 * s: 2 * s + rows + 2, cb: c1 + 2]
                    a = torch.cat([nbh[tr: tr + rows, tc: tc + wt]
                                   for tr in range(3) for tc in range(3)], -1)
                    t = (a.reshape(-1, 432) @ w2).to(dt).float()
                    t = t.reshape(rows, wt, 2, 2, 64) * sgn  # (pr, pc, f)
                    left = F.pad(t[:, :-1, :, 1], (0, 0, 0, 0, 1, 0),
                                 value=lost)
                    cp = torch.maximum(t.amax(dim=3), left)  # [rows, wt, pr, f]
                    up = torch.full_like(cp[:, :, 1], lost)
                    if carry is not None:
                        up[0] = carry
                    up[1:] = cp[:-1, :, 1]
                    if s >= lo:
                        pool = torch.maximum(cp.amax(dim=2), up) * sgn
                        y = torch.relu(pool * scale.float()
                                       + bias.float()).to(dt)
                        out[fr, 2 * s: 2 * s + rows, c0:c1] = y[:, c0 - cb:]
                    carry = cp[-1, :, 1]
    return out


def s2d_cells(frames: torch.Tensor) -> torch.Tensor:
    """NHWC frames [N, H, W, C] (H, W % 4 == 0) -> their 4x4 cells
    [N, H/4, W/4, 16 C], channel (dy, dx, c)."""
    n, h, w, c = frames.shape
    x = frames.reshape(n, h // 4, 4, w // 4, 4, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // 4, w // 4, 16 * c)


def _inputs(seed, n, hs):
    rng = np.random.default_rng(seed)
    s4 = rng.integers(0, 256, (n, hs, hs, 48), np.uint8)
    w7 = (rng.standard_normal((7, 7, 3, 64)) * 0.1).astype(np.float32)
    s = (rng.standard_normal(64) * 0.5 + 1).astype(np.float32)
    s[::5] *= -1  # a folded BN scale can be negative: that pool flips
    b = rng.standard_normal(64).astype(np.float32)
    return s4, w7, s, b


def _cells(s4):
    frames = normalize_frames_reference(depth_to_space4(torch.from_numpy(s4)))
    return s2d_cells(frames)


@pytest.mark.parametrize("px", [32, 64])
def test_phase_stem_matches_reference_and_pallas(px):
    s4, w7, s, b = _inputs(px, 3, px // 4)
    args = [torch.from_numpy(a) for a in (w7, s, b)]
    ref = stem_s2d_reference(torch.from_numpy(s4), *args, torch.float32)
    want = np.asarray(stem_s2d_pallas(jnp.asarray(s4), jnp.asarray(w7),
                                      jnp.asarray(s), jnp.asarray(b),
                                      out_dtype=jnp.float32))
    cells = _cells(s4)
    strips = (px // 4 + 1) // 2
    for bands in range(1, strips + 1):
        got = stem_phase_plain(cells, *args, bands).numpy()
        np.testing.assert_allclose(got, ref.numpy(), **TOL)
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("px", [32, 64])
def test_phase_stem_on_frames_matches_the_frames_stem(px):
    """K8's path: the frames' own 4x4 cells, already normalized."""
    rng = np.random.default_rng(px + 1)
    frames = torch.from_numpy(
        rng.standard_normal((2, px, px, 3)).astype(np.float32))
    _, w7, s, b = _inputs(px + 2, 1, 1)
    args = [torch.from_numpy(a) for a in (w7, s, b)]
    ref = stem_frames_reference(frames, *args)
    for bands in (1, 2, px // 8):
        got = stem_phase_plain(s2d_cells(frames), *args, bands)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)


@pytest.mark.parametrize("px,tile", [(32, 3), (44, 4), (48, 4)])
def test_phase_stem_in_column_chunks(px, tile):
    """Frames walked in column chunks of tiles of 3-4 cells (an odd cell
    count at 44 px): every chunk seam, for every band split, against the
    plain stem and the JAX kernel; every output cell stored once."""
    s4, w7, s, b = _inputs(px + 7, 2, px // 4)
    args = [torch.from_numpy(a) for a in (w7, s, b)]
    ref = stem_s2d_reference(torch.from_numpy(s4), *args, torch.float32)
    want = np.asarray(stem_s2d_pallas(jnp.asarray(s4), jnp.asarray(w7),
                                      jnp.asarray(s), jnp.asarray(b),
                                      out_dtype=jnp.float32))
    cells = _cells(s4)
    assert len(chunk_spans(px // 4, tile)) > 2
    for bands in range(1, (px // 4 + 1) // 2 + 1):
        got = stem_phase_plain(cells, *args, bands, tile=tile).numpy()
        np.testing.assert_allclose(got, ref.numpy(), **TOL)
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("ws", [56, 64, 65, 80, 126, 127, 300])
def test_stem_chunks_cover_the_row(ws):
    """The port's chunk count (ops/stem.py) is the rule chunk_spans uses:
    the chunks tile the row, and a tile with its extra cell holds at most
    64 cells; up to 64 cells (224 px frames) the row is one chunk."""
    spans = chunk_spans(ws)
    assert len(spans) == stem_chunks(ws)
    assert spans[0][0] == 0 and spans[-1][2] == ws
    assert all(a[2] == b[0] for a, b in zip(spans, spans[1:]))
    assert all(c1 - cb <= STEM_TILE_CELLS for _, cb, c1 in spans)
    assert (len(spans) == 1) == (ws <= STEM_TILE_CELLS)


def test_phase_stem_with_a_one_row_last_strip():
    """An odd number of cell rows (36 px): the last strip holds one row."""
    s4, w7, s, b = _inputs(5, 2, 9)
    args = [torch.from_numpy(a) for a in (w7, s, b)]
    ref = stem_s2d_reference(torch.from_numpy(s4), *args, torch.float32)
    for bands in range(1, 6):
        got = stem_phase_plain(_cells(s4), *args, bands)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)


def test_phase_stem_in_bf16_rounds_like_the_reference():
    """The kernel's roundings (the conv sum to bf16 once, then the affine
    and ReLU, rounded) against the plain bf16 stem: the bf16 bands of
    the card's check."""
    s4, w7, s, b = _inputs(6, 2, 16)
    args = [torch.from_numpy(a) for a in (w7, s, b)]
    ref = stem_s2d_reference(torch.from_numpy(s4), *args).float().flatten()
    cells = _cells(s4).to(torch.bfloat16)
    got = stem_phase_plain(cells, *args, 3, torch.bfloat16).float().flatten()
    cos = torch.nn.functional.cosine_similarity(got, ref, dim=0).item()
    mrel = ((got - ref).abs().mean() / ref.abs().mean()).item()
    assert cos >= 0.999 and mrel <= 1e-2, (cos, mrel)


@pytest.mark.parametrize("n,hs,sms,want", [
    (256, 56, 132, 1),   # a serving call: whole frames, 2 waves
    (192, 56, 132, 2),   # a window-scoring call: half frames
    (4, 56, 132, 28),    # few frames: one strip a band
    (64, 16, 132, 2),    # bands of 4 strips
])
def test_stem_bands_balance_the_walk(n, hs, sms, want):
    bands = stem_bands(n, hs, sms)
    assert bands == want
    strips = (hs + 1) // 2
    # the kernel's split: every strip in exactly one band, none empty
    spans = [(i * strips // bands, (i + 1) * strips // bands)
             for i in range(bands)]
    assert spans[0][0] == 0 and spans[-1][1] == strips
    assert all(lo < hi for lo, hi in spans)
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
