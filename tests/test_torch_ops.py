"""The PyTorch port's ops against the JAX package on the CPU.

The kernels' plain versions (stem_s2d_reference, tsm_bottleneck_reference)
are held against the JAX Pallas kernels run in interpret mode and against
the JAX XLA references, in float32 on the same numpy inputs. Tolerance
1e-4 absolute and relative: both sides compute in float32 but sum in
different orders (XLA conv vs oneDNN conv vs Pallas im2col dots).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from video_chapter_generation_tpu.data.native_loader import space_to_depth4
from video_chapter_generation_tpu.ops.preprocess import (
    normalize_frames as jax_normalize_frames,
)
from video_chapter_generation_tpu.ops.stem_pallas import stem_s2d_pallas
from video_chapter_generation_tpu.ops.temporal_shift import (
    temporal_shift as jax_temporal_shift,
)
from video_chapter_generation_tpu.ops.tsm_block_pallas import (
    tsm_bottleneck_pallas,
    tsm_bottleneck_reference as jax_tsm_bottleneck_reference,
    tsm_bottleneck_s2_pallas,
    tsm_bottleneck_s2_planar_pallas,
)
from video_chapter_generation_tpu_torch.ops.preprocess import (
    depth_to_space4,
    normalize_frames,
)
from video_chapter_generation_tpu_torch.ops.stem import (
    stem_s2d,
    stem_s2d_reference,
)
from video_chapter_generation_tpu_torch.ops.temporal_shift import (
    temporal_shift,
)
from video_chapter_generation_tpu_torch.ops.tsm_block import (
    tsm_bottleneck,
    tsm_bottleneck_reference,
    tsm_bottleneck_s2,
)

TOL = dict(rtol=1e-4, atol=1e-4)
T = 4  # clip length (n_segment)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _block_params(rng, c_in, f, c_out):
    """Random block weights (JAX layout) with BN affines whose positive
    biases make relu(b) != 0, so wrong edge padding would show."""
    mk = lambda *s: (rng.standard_normal(s) * 0.1).astype(np.float32)  # noqa: E731
    aff = lambda n: (  # noqa: E731
        (rng.standard_normal(n) * 0.2 + 1).astype(np.float32),
        (rng.standard_normal(n) * 0.1 + 0.3).astype(np.float32))
    return {"w1": mk(c_in, f), "w2": mk(3, 3, f, f), "w3": mk(f, c_out),
            "wp": mk(c_in, c_out), "a1": aff(f), "a2": aff(f),
            "a3": aff(c_out), "ap": aff(c_out)}


def _main_args(p):
    return (p["w1"], p["w2"], p["w3"], *p["a1"], *p["a2"], *p["a3"])


def test_normalize_frames_matches_jax():
    u8 = np.random.default_rng(0).integers(0, 256, (2, 8, 8, 3), np.uint8)
    want = np.asarray(jax_normalize_frames(jnp.asarray(u8)))
    got = normalize_frames(_t(u8)).numpy()
    # same float32 constants; XLA fuses the multiply-add (one rounding
    # instead of two), so the two may differ in the last bit
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_depth_to_space_undoes_the_host_pack():
    """The port unpacks what the host loader packs (the JAX package's
    space_to_depth4, which the native decoder mirrors)."""
    u8 = np.random.default_rng(1).integers(0, 256, (2, 16, 16, 3), np.uint8)
    s4 = space_to_depth4(u8)
    # channel order (dy, dx, c): pixel (4I+dy, 4J+dx, c) at dy*12+dx*3+c
    assert s4[1, 2, 3, 2 * 12 + 1 * 3 + 2] == u8[1, 4 * 2 + 2, 4 * 3 + 1, 2]
    np.testing.assert_array_equal(depth_to_space4(_t(s4)).numpy(), u8)


@pytest.mark.parametrize("n_div", [8, 4])
def test_temporal_shift_matches_jax(n_div):
    x = np.random.default_rng(2).standard_normal((2 * T, 3, 3, 16))
    x = x.astype(np.float32)
    want = np.asarray(jax_temporal_shift(jnp.asarray(x), T, n_div))
    np.testing.assert_array_equal(temporal_shift(_t(x), T, n_div).numpy(),
                                  want)


def test_stem_s2d_reference_matches_pallas():
    rng = np.random.default_rng(3)
    s4 = rng.integers(0, 256, (4, 16, 16, 48), np.uint8)  # 64-px frames
    w7 = (rng.standard_normal((7, 7, 3, 64)) * 0.1).astype(np.float32)
    s = (rng.standard_normal(64) * 0.5 + 1).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    want = np.asarray(stem_s2d_pallas(jnp.asarray(s4), jnp.asarray(w7),
                                      jnp.asarray(s), jnp.asarray(b),
                                      out_dtype=jnp.float32))
    got = stem_s2d_reference(_t(s4), _t(w7), _t(s), _t(b), torch.float32)
    assert got.shape == (4, 16, 16, 64)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the wrapper takes the plain version for a CPU tensor, and counts no
    # kernel launch
    before = stem_s2d.launches
    np.testing.assert_array_equal(
        stem_s2d(_t(s4), _t(w7), _t(s), _t(b), torch.float32).numpy(),
        got.numpy())
    assert stem_s2d.launches == before


@pytest.mark.parametrize("width", [8, 12])
def test_tsm_bottleneck_reference_matches_pallas(width):
    rng = np.random.default_rng(4)
    c = 32
    p = _block_params(rng, c, 8, c)
    x = rng.standard_normal((2 * T, 8, width, c)).astype(np.float32)
    jargs = [jnp.asarray(a) for a in _main_args(p)]
    want_pl = np.asarray(tsm_bottleneck_pallas(jnp.asarray(x), *jargs, T))
    want_xla = np.asarray(jax_tsm_bottleneck_reference(jnp.asarray(x),
                                                       *jargs, T))
    got = tsm_bottleneck_reference(_t(x), *map(_t, _main_args(p)), T)
    np.testing.assert_allclose(got.numpy(), want_pl, **TOL)
    np.testing.assert_allclose(got.numpy(), want_xla, **TOL)
    before = tsm_bottleneck.launches
    np.testing.assert_array_equal(
        tsm_bottleneck(_t(x), *map(_t, _main_args(p)), T).numpy(),
        got.numpy())
    assert tsm_bottleneck.launches == before


def test_tsm_bottleneck_projection_matches_pallas():
    """Stride-1 block with the 1x1 projection residual (layer 1's block0:
    C_in = 64 -> 4F = 256 at full size)."""
    rng = np.random.default_rng(5)
    p = _block_params(rng, 16, 8, 32)
    x = rng.standard_normal((2 * T, 8, 8, 16)).astype(np.float32)
    want = np.asarray(tsm_bottleneck_pallas(
        jnp.asarray(x), *map(jnp.asarray, _main_args(p)), T,
        wp=jnp.asarray(p["wp"]), sp=jnp.asarray(p["ap"][0]),
        bp=jnp.asarray(p["ap"][1])))
    got = tsm_bottleneck(_t(x), *map(_t, _main_args(p)), T, 8, _t(p["wp"]),
                         *map(_t, p["ap"]))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("planar", [False, True], ids=["nhwc", "planar"])
def test_tsm_bottleneck_s2_matches_pallas(planar):
    """Stride-2 block0 against both TPU kernels: the planar one takes the
    same NHWC bytes as [N, H, W/2, 2C] (a row-major view)."""
    rng = np.random.default_rng(6)
    c_in, f = 16, 8
    p = _block_params(rng, c_in, f, 4 * f)
    x = rng.standard_normal((2 * T, 8, 12, c_in)).astype(np.float32)
    jargs = [jnp.asarray(a) for a in (*_main_args(p), p["wp"], *p["ap"])]
    if planar:
        xin = jnp.asarray(x.reshape(2 * T, 8, 6, 2 * c_in))
        want = tsm_bottleneck_s2_planar_pallas(xin, *jargs, T)
    else:
        want = tsm_bottleneck_s2_pallas(jnp.asarray(x), *jargs, T)
    got = tsm_bottleneck_s2(_t(x), *map(_t, _main_args(p)), _t(p["wp"]),
                            *map(_t, p["ap"]), T)
    assert got.shape == (2 * T, 4, 6, 4 * f)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
