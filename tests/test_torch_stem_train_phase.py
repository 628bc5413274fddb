"""The training stem kernel's decomposition (K11) in plain torch, on the CPU.

csrc/stem_train.cu computes the training stem in the TPU kernel's
phase-packed form: the conv output yc of s2d cell (I, J) is one row of
A[cells, 432] x W[432, 256] (the 4 conv-output phases x 64 filters), its
batch moments are column sums folded over the 4 phases, the max pool and
its gradient read the phases by parity (phase (0, 0) lies in window
(I, J) only, (0, 1) also in (I, J + 1), (1, 0) also in (I + 1, J), (1, 1)
in all four; every position equal to the window max receives its
gradient), and the weight gradient is the phase-packed dw2 = z^T du,
summed over pixel splits of strips and stages, folded back to
[7, 7, 3, 64] through the transpose of the phase selection (the kernel
gathers the four terms of each tap). A frame row wider than a tile's 64
cells is walked in column chunks (no extra cell: the training epilogue
pools nothing): each tile's product reads its neighbourhood across the
chunk seams, and the weight gradient's stages take a chunk's two cell
rows as two runs of cells. `stem_train_phase_plain` below is that
decomposition in plain torch, with the tile width as a parameter (tiles
of 3-4 cells put chunk seams into 32-44 px frames); here it is held to the port's plain
version (`stem_train_reference`, differentiated by autograd) in float64,
where inputs on a small integer grid make ties in the pool windows common,
and to the JAX Pallas kernel (interpret mode, as
tests/test_torch_train_ops.py runs it) in float32 at that file's
tolerances: 1e-4 for the forward, 2e-4 of the largest magnitude for the
gradients.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from video_chapter_generation_tpu.ops.stem_train_pallas import (
    stem_s2d_train as jax_stem_s2d_train,
)
from video_chapter_generation_tpu_torch.ops.preprocess import (
    depth_to_space4,
    normalize_frames_reference,
)
from video_chapter_generation_tpu_torch.ops.stem import (
    STEM_TILE_CELLS,
    _phase_selection,
    stem_weight_im2col,
)
from video_chapter_generation_tpu_torch.ops.stem_train import (
    _kernel_input,
    maxpool_ties,
    stem_train_reference,
)
from video_chapter_generation_tpu_torch.ops.tsm_block_train import bn_train
from test_torch_stem_phase import chunk_spans

EPS = 1e-5
FWD_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_REL = 2e-4
SPLITS_MAX = 33  # the kernel's pixel splits: 132 SMs / 4 row tiles


def _patches(cells: torch.Tensor) -> torch.Tensor:
    """z [N, hs, ws, 432]: the 3x3 cell neighbourhood of each cell, k =
    (tap_r, tap_c, ch48), zero cells outside the frame."""
    n, hs, ws, _ = cells.shape
    padded = F.pad(cells, (0, 0, 1, 1, 1, 1))
    return torch.cat([padded[:, tr:tr + hs, tc:tc + ws]
                      for tr in range(3) for tc in range(3)], -1)


def _tile4(v: torch.Tensor) -> torch.Tensor:
    return v.reshape(1, 64).repeat(1, 4).reshape(256)


def _fold4(v: torch.Tensor) -> torch.Tensor:
    """[..., 256] -> [..., 64]: the 4 phases summed in order."""
    p = v.reshape(*v.shape[:-1], 4, 64)
    return ((p[..., 0, :] + p[..., 1, :]) + p[..., 2, :]) + p[..., 3, :]


def phase_pool(y: torch.Tensor) -> torch.Tensor:
    """The 3x3/2 max pool (pad 1) of phase-packed y [N, hs, ws, 256] read
    by cell phase: output (I, J) takes the 4 phases of cell (I, J), phases
    1 and 3 of (I, J - 1), 2 and 3 of (I - 1, J) and 3 of (I - 1, J - 1)."""
    p = y.reshape(*y.shape[:3], 4, 64)
    lost = float("-inf")
    left = F.pad(p[:, :, :-1], (0, 0, 0, 0, 1, 0), value=lost)
    up = F.pad(p[:, :-1], (0, 0, 0, 0, 0, 0, 1, 0), value=lost)
    upleft = F.pad(up[:, :, :-1], (0, 0, 0, 0, 1, 0), value=lost)
    vals = [p[..., 0, :], p[..., 1, :], p[..., 2, :], p[..., 3, :],
            left[..., 1, :], left[..., 3, :], up[..., 2, :], up[..., 3, :],
            upleft[..., 3, :]]
    return torch.stack(vals).amax(0)


def phase_route(y, pooled, dpool):
    """The pool's gradient by phase parity, before relu': phase (pr, pc) of
    cell (I, J) receives window (I, J), plus (I + 1, J) where pr = 1 and
    (I, J + 1) where pc = 1, and (I + 1, J + 1) for (1, 1), each where it
    equals the window max; in the TPU kernel's order (own, below, right,
    below-right). y, the result [N, hs, ws, 256]."""
    p = y.reshape(*y.shape[:3], 4, 64)
    nothing = float("nan")  # past the frame: no window, equal to nothing
    down = lambda t: F.pad(t[:, 1:], (0, 0, 0, 0, 0, 1),  # noqa: E731
                           value=nothing)
    right = lambda t: F.pad(t[:, :, 1:], (0, 0, 0, 1),  # noqa: E731
                            value=nothing)
    wins = [(pooled, dpool), (down(pooled), down(dpool)),
            (right(pooled), right(dpool)),
            (down(right(pooled)), down(right(dpool)))]
    per_phase = {0: (0,), 1: (0, 2), 2: (0, 1), 3: (0, 1, 2, 3)}
    out = []
    for ph in range(4):
        acc = torch.zeros_like(p[..., ph, :])
        for w in per_phase[ph]:
            pm, dp = wins[w]
            acc = acc + torch.where(p[..., ph, :] == pm, dp.nan_to_num(),
                                    torch.zeros_like(acc))
        out.append(acc)
    return torch.stack(out, -2).reshape(y.shape)


def unit_tiles(n, hs, ws, tile=STEM_TILE_CELLS):
    """The walk's units in order, (frame, strip, c0, c1): each strip of 2
    cell rows of each column chunk (chunk_spans without the extra cell)."""
    sp = (hs + 1) // 2
    return [(fr, s, c0, c1) for fr in range(n) for s in range(sp)
            for c0, _, c1 in chunk_spans(ws, tile, overlap=False)]


def tile_product(cells: torch.Tensor, w2: torch.Tensor,
                 tile=STEM_TILE_CELLS) -> torch.Tensor:
    """yc [N, hs, ws, 256] as the forward's tiles compute it: each unit's
    cells from the unit's neighbourhood (cell rows 2s - 1 .. 2s + 2,
    columns c0 - 1 .. c1: the real cells across a chunk seam, zero outside
    the frame), stored at their cells."""
    n, hs, ws, _ = cells.shape
    padded = F.pad(cells, (0, 0, 1, 1, 1, 1))
    yc = torch.full((n, hs, ws, 256), float("nan"), dtype=cells.dtype)
    for fr, s, c0, c1 in unit_tiles(n, hs, ws, tile):
        rows, wt = min(2, hs - 2 * s), c1 - c0
        nbh = padded[fr, 2 * s:2 * s + rows + 2, c0:c1 + 2]
        a = torch.cat([nbh[tr:tr + rows, tc:tc + wt]
                       for tr in range(3) for tc in range(3)], -1)
        yc[fr, 2 * s:2 * s + rows, c0:c1] = a @ w2
    return yc


def wgrad_walk(cells: torch.Tensor, du: torch.Tensor,
               tile=STEM_TILE_CELLS) -> torch.Tensor:
    """dw2 [448, 256] as the kernel's weight gradient walks it: pixel
    splits of consecutive units (unit_tiles) over all frames, z rows
    copied from the unit's neighbourhood (cell rows 2s - 1 .. 2s + 2, one
    cell beyond the chunk each side) by channel group g < 27 of tap
    g // 3, rows past the unit zero; with one chunk a row a unit's cells
    are one run, 64 a stage, else each of its two cell rows is a stage;
    the splits summed in order. du [N hs ws, 256]."""
    n, hs, ws, _ = cells.shape
    units = unit_tiles(n, hs, ws, tile)
    one = len(chunk_spans(ws, tile)) == 1
    sps = (2 * ws + 63) // 64 if one else 2
    splits = max(1, min(SPLITS_MAX, len(units)))
    padded = F.pad(cells, (0, 0, 1, 1, 1, 1, 0, 0))
    padded = F.pad(padded, (0, 0, 0, 0, 0, 1))  # a row below a last odd one
    total = torch.zeros(448, 256, dtype=cells.dtype)
    for z in range(splits):
        part = torch.zeros(448, 256, dtype=cells.dtype)
        for u in range(z * len(units) // splits,
                       (z + 1) * len(units) // splits):
            fr, s, c0, c1 = units[u]
            nrows, wt = min(2, hs - 2 * s), c1 - c0
            nbh = padded[fr, 2 * s:2 * s + 4, c0:c1 + 2]  # [4, wt + 2, 48]
            for h in range(sps):
                cr = torch.arange(64)
                if one:
                    r = 64 * h + cr
                    ok = r < nrows * wt
                    first = (fr * hs + 2 * s) * ws + 64 * h
                else:
                    r = h * wt + cr
                    ok = (cr < wt) & (h < nrows)
                    first = (fr * hs + 2 * s + h) * ws + c0
                lr, jc = r // wt, r % wt
                a = torch.zeros(64, 448, dtype=cells.dtype)
                for g in range(27):
                    tap, cc = divmod(g, 3)
                    tr, tc = divmod(tap, 3)
                    src = nbh[(lr + tr).clamp(max=3), (jc + tc).clamp(
                        max=wt + 1), 16 * cc:16 * cc + 16]
                    a[:, 16 * g:16 * g + 16] = torch.where(ok[:, None], src,
                                                           0.0)
                g_rows = du[(first + cr).clamp(max=du.shape[0] - 1)]
                part += a.t() @ torch.where(ok[:, None], g_rows, 0.0)
        total += part
    return total


def fold_dw(dw2: torch.Tensor) -> torch.Tensor:
    """dw7 [7, 7, 3, 64] from dw2 [448, 256] as the kernel's fold gathers
    it: tap (dr, dc, c) of phase (pr, pc) is dw2 row (tr, tc, di, dj, c)
    with 4 tr + di = dr + 2 pr + 1 (likewise columns); four terms summed in
    phase order."""
    out = torch.zeros(147, 64, dtype=dw2.dtype)
    for dd in range(147):
        c, tap = dd % 3, dd // 3
        dr, dc = divmod(tap, 7)
        for ph in range(4):
            ur, uc = dr + 2 * (ph >> 1) + 1, dc + 2 * (ph & 1) + 1
            rk = ((ur >> 2) * 144 + (uc >> 2) * 48 + (ur & 3) * 12
                  + (uc & 3) * 3 + c)
            out[dd] = out[dd] + dw2[rk, 64 * ph:64 * ph + 64]
    return out.reshape(7, 7, 3, 64)


def stem_train_phase_plain(cells, w7, gamma, beta, dpool, eps=EPS,
                           tile=STEM_TILE_CELLS):
    """The kernel's decomposition: cells [N, hs, ws, 48] normalized s2d
    cells -> (out [N, hs, ws, 64], (mu, var), (dw7, dgamma, dbeta), da
    [N, hs, ws, 256], dw2 [448, 256]) for the pool gradient dpool, on
    tiles of at most `tile` cells a row."""
    n, hs, ws, _ = cells.shape
    dt = cells.dtype
    w2 = stem_weight_im2col(w7).to(dt)
    yc = tile_product(cells, w2, tile)  # column (pr * 2 + pc) * 64 + f
    count = n * 4 * hs * ws
    m0 = _fold4(yc.reshape(-1, 256).sum(0))
    m1 = _fold4((yc * yc).reshape(-1, 256).sum(0))
    mu = m0 / count
    var = m1 / count - mu * mu
    r = torch.rsqrt(var + eps)
    sa = gamma.to(dt) * r
    sb = beta.to(dt) - mu * sa
    y = torch.relu(yc * _tile4(sa) + _tile4(sb))
    pooled = phase_pool(y)
    da = phase_route(y, pooled, dpool)
    da = torch.where(y > 0, da, torch.zeros_like(da))
    s0 = _fold4(da.reshape(-1, 256).sum(0))
    s1 = _fold4((da * (yc - _tile4(mu))).reshape(-1, 256).sum(0))
    a = gamma.to(dt) * r
    t0, t1 = s0 / count, r * s1 / count
    e, f = -a * t1 * r, -a * t0 + a * t1 * r * mu
    du = da * _tile4(a) + yc * _tile4(e) + _tile4(f)
    dw2 = wgrad_walk(cells, du.reshape(-1, 256), tile)
    return (pooled, (mu, var), (fold_dw(dw2), r * s1, s0), da, dw2)


def _cells(frames: torch.Tensor) -> torch.Tensor:
    n, h, w, c = frames.shape
    x = frames.reshape(n, h // 4, 4, w // 4, 4, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // 4, w // 4, 16 * c)


def _reference(frames, w7, gamma, beta, dpool):
    """stem_train_reference and its gradients, plus the gradient at the BN
    output's conv grid (the routed da) by autograd."""
    ps = [t.clone().requires_grad_() for t in (w7, gamma, beta)]
    out, (mu, var) = stem_train_reference(frames, *ps, EPS)
    grads = torch.autograd.grad(out, ps, dpool)
    yc = F.conv2d(frames.permute(0, 3, 1, 2), w7.permute(3, 2, 0, 1),
                  stride=2, padding=3)
    a, _, _ = bn_train(yc, gamma, beta, EPS, dims=(0, 2, 3))
    a = a.detach().requires_grad_()
    pooled = maxpool_ties(torch.relu(a))
    (da,) = torch.autograd.grad(pooled, a, dpool.permute(0, 3, 1, 2))
    return out, (mu, var), grads, da


def _conv_grid(pp: torch.Tensor) -> torch.Tensor:
    """Phase-packed [N, hs, ws, 256] -> the conv grid [N, 64, 2hs, 2ws]."""
    n, hs, ws, _ = pp.shape
    g = pp.reshape(n, hs, ws, 2, 2, 64).permute(0, 5, 1, 3, 2, 4)
    return g.reshape(n, 64, 2 * hs, 2 * ws)


def _grid_inputs(seed, n, px):
    """float64 frames and weights on a small integer grid: equal conv
    outputs are common, so pool windows hold ties among positive
    activations (the BN maps equal inputs to equal outputs)."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(-1, 2, (n, px, px, 3)).astype(np.float64)
    w7 = rng.integers(-1, 2, (7, 7, 3, 64)).astype(np.float64)
    gamma = 1.0 + 0.25 * rng.integers(-2, 3, 64)
    gamma[::9] *= -1  # a negative BN scale
    beta = 0.5 * rng.integers(-2, 3, 64).astype(np.float64)
    dpool = rng.standard_normal((n, px // 4, px // 4, 64))
    return [torch.from_numpy(a) for a in (frames, w7, gamma, beta, dpool)]


# (frames, px): one stage a strip (ws <= 32), two stages a strip with a
# ragged second (136 px: 68 rows), an odd cell-row count (36 px: a last
# strip of one row), and more strips than pixel splits (n 9 at 32 px)
CASES = [(2, 32), (1, 136), (3, 36), (9, 32)]
# (frames, px, tile cells): column chunks of 3 and 4 cells (chunk seams;
# 11 cells at 44 px, a one-row last strip at 36 px, more units than
# pixel splits at n 6)
CHUNK_CASES = [(2, 44, 4), (1, 36, 3), (6, 32, 4)]


@pytest.mark.parametrize("n,px", CASES)
def test_phase_stem_train_matches_reference(n, px):
    _hold_to_reference(n, px, STEM_TILE_CELLS)


@pytest.mark.parametrize("n,px,tile", CHUNK_CASES)
def test_phase_stem_train_in_column_chunks(n, px, tile):
    _hold_to_reference(n, px, tile)


def _hold_to_reference(n, px, tile):
    frames, w7, gamma, beta, dpool = _grid_inputs(n * 100 + px, n, px)
    out, (mu, var), grads, da, _ = stem_train_phase_plain(
        _cells(frames), w7, gamma, beta, dpool, tile=tile)
    r_out, (r_mu, r_var), r_grads, r_da = _reference(frames, w7, gamma,
                                                     beta, dpool)
    tol = dict(rtol=1e-9, atol=1e-9)
    torch.testing.assert_close(out, r_out, **tol)
    torch.testing.assert_close(mu, r_mu, **tol)
    torch.testing.assert_close(var, r_var, **tol)
    # the routing, ties included: the same gradient at every conv pixel
    torch.testing.assert_close(_conv_grid(da), r_da, **tol)
    for g, rg in zip(grads, r_grads):
        torch.testing.assert_close(g, rg, rtol=1e-9,
                                   atol=1e-9 * float(rg.abs().max()))


def test_grid_inputs_hold_ties():
    """The integer grid does make windows with several maxima among
    positive activations, so the test above checks ties."""
    frames, w7, gamma, beta, _ = _grid_inputs(7, 2, 32)
    yc = F.conv2d(frames.permute(0, 3, 1, 2), w7.permute(3, 2, 0, 1),
                  stride=2, padding=3)
    a, _, _ = bn_train(yc, gamma, beta, EPS, dims=(0, 2, 3))
    y = torch.relu(a)
    pooled = F.max_pool2d(y, 3, 2, 1)
    patches = F.unfold(y, 3, padding=1, stride=2).view(*y.shape[:2], 9, -1)
    hits = (patches == pooled.flatten(2)[:, :, None]).sum(2)
    assert int(((hits > 1) & (pooled.flatten(2) > 0)).sum()) > 100


def test_phase_fold_is_the_selection_transpose():
    """The kernel's gather of four terms a tap equals the einsum of the
    transposed phase selection (stem_train_pallas.py:314-319), exactly."""
    dw2 = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (448, 256)))
    sel = torch.from_numpy(_phase_selection()).double()
    want = torch.einsum("prd,rpf->df", sel,
                        dw2[:432].reshape(432, 4, 64)).reshape(7, 7, 3, 64)
    torch.testing.assert_close(fold_dw(dw2), want, rtol=0, atol=1e-12)


def test_phase_product_is_the_conv():
    """yc from the phase-packed product is the 7x7/2 conv (pad 3) at each
    conv pixel (2I + pr, 2J + pc)."""
    frames, w7, *_ = _grid_inputs(11, 2, 40)
    yc = _patches(_cells(frames)) @ stem_weight_im2col(w7).double()
    want = F.conv2d(frames.permute(0, 3, 1, 2), w7.permute(3, 2, 0, 1),
                    stride=2, padding=3)
    torch.testing.assert_close(_conv_grid(yc), want, rtol=0, atol=1e-9)


@pytest.mark.parametrize("px", [16, 32])
def test_phase_stem_train_matches_jax(px):
    """float32, random u8 pixels (no ties), against the JAX kernel."""
    rng = np.random.default_rng(px)
    s4 = rng.integers(0, 256, (3, px // 4, px // 4, 48)).astype(np.uint8)
    w7 = (rng.standard_normal((7, 7, 3, 64)) / np.sqrt(147)).astype(
        np.float32)
    gamma = (1.0 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(64)).astype(np.float32)
    cot = rng.standard_normal((3, px // 4, px // 4, 64)).astype(np.float32)
    (y_ref, st_ref), vjp = jax.vjp(
        lambda *a: jax_stem_s2d_train(jnp.asarray(s4), *a, EPS, jnp.float32),
        *[jnp.asarray(a) for a in (w7, gamma, beta)])
    g_ref = vjp((jnp.asarray(cot),
                 jax.tree_util.tree_map(jnp.zeros_like, st_ref)))
    frames = normalize_frames_reference(depth_to_space4(torch.from_numpy(s4)))
    out, (mu, var), grads, _, _ = stem_train_phase_plain(
        _cells(frames), *[torch.from_numpy(a) for a in (w7, gamma, beta,
                                                          cot)])
    np.testing.assert_allclose(out.numpy(), np.asarray(y_ref), **FWD_TOL)
    for s, sr in zip((mu, var), st_ref):
        np.testing.assert_allclose(s.numpy(), np.asarray(sr), **FWD_TOL)
    for name, g, w in zip(("dw7", "dgamma", "dbeta"), grads, g_ref):
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-3)
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_REL,
                                   atol=GRAD_REL * scale, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.bfloat16])
def test_kernel_input_copies_a_misaligned_input(dtype):
    """uint8 cells or bf16 frames that do not start on 16 bytes reach the
    kernel as an aligned copy with the same values; an aligned input is
    read in place."""
    n, hs, ws = 2, 3, 5
    shape = (n, hs, ws, 48) if dtype == torch.uint8 else (n, 4 * hs,
                                                          4 * ws, 3)
    buf = torch.arange(n * hs * ws * 48 + 1).remainder(251).to(dtype)
    s4 = buf[1:].view(shape)
    assert s4.data_ptr() % 16
    x = _kernel_input(s4)
    assert x.data_ptr() % 16 == 0 and torch.equal(x, s4)
    assert _kernel_input(x).data_ptr() == x.data_ptr()


@pytest.mark.parametrize("px", [256, 260])
def test_kernel_input_takes_frames_up_to_256_px(px):
    """Frames up to 256 px wide are one column chunk; wider ones (260 px:
    65 cells, an odd count) are taken too, in two chunks: the kernel's
    input is the frames or cells as they are, and the decomposition of
    the walk at that width (tiles of at most 64 cells) equals the plain
    version, routing and gradients included (float64)."""
    cells = torch.zeros(1, 2, px // 4, 48, dtype=torch.uint8)
    frames = torch.zeros(1, 8, px, 3, dtype=torch.bfloat16)
    assert _kernel_input(cells).shape == cells.shape
    assert _kernel_input(frames).shape == frames.shape
    assert len(chunk_spans(px // 4)) == (1 if px <= 256 else 2)
    frames, w7, gamma, beta, dpool = _grid_inputs(px, 1, px)
    frames, dpool = frames[:, :8], dpool[:, :2]
    out, (mu, var), grads, da, _ = stem_train_phase_plain(
        _cells(frames), w7, gamma, beta, dpool)
    r_out, (r_mu, r_var), r_grads, r_da = _reference(frames, w7, gamma,
                                                     beta, dpool)
    tol = dict(rtol=1e-9, atol=1e-9)
    torch.testing.assert_close(out, r_out, **tol)
    torch.testing.assert_close(_conv_grid(da), r_da, **tol)
    for g, rg in zip(grads, r_grads):
        torch.testing.assert_close(g, rg, rtol=1e-9,
                                   atol=1e-9 * float(rg.abs().max()))
