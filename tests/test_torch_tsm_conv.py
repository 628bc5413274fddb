"""K5 (shift + 1x1 conv), K6 (frame normalize) and K7 (temporal shift):
the port's plain versions, which the wrappers take on CPU tensors,
against the JAX package's Pallas kernels in interpret mode and its XLA
forms, on the same seeded numpy inputs.

Tolerances: float32 products at 1e-4 absolute and relative (sums in
different orders; the JAX kernels round scale and bias to x.dtype, here
float32, so the forms agree), gradients at 1e-3 (the tests of the JAX
kernel itself, tests/test_tsm_conv_pallas.py, hold them there); the
shift is a copy and equal; normalize within one float32 ulp (XLA fuses
the multiply-add, the port rounds twice, ROADMAP queue 3)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from video_chapter_generation_tpu.ops.preprocess import (
    normalize_frames_pallas,
)
from video_chapter_generation_tpu.ops.temporal_shift import (
    temporal_shift as jax_temporal_shift,
    temporal_shift_conv1x1 as jax_shift_conv,
    temporal_shift_conv1x1_3tap as jax_shift_conv_3tap,
    temporal_shift_pallas,
)
from video_chapter_generation_tpu.ops.tsm_conv_pallas import (
    tsm_conv1x1_bn_relu_pallas,
    tsm_conv1x1_pallas,
)
from video_chapter_generation_tpu_torch.ops.preprocess import (
    normalize_frames,
    normalize_frames_reference,
)
from video_chapter_generation_tpu_torch.ops.temporal_shift import (
    temporal_shift,
    temporal_shift_conv1x1,
    temporal_shift_conv1x1_3tap,
    temporal_shift_reference,
)
from video_chapter_generation_tpu_torch.ops.tsm_conv import (
    tsm_conv1x1,
    tsm_conv1x1_bn_relu,
    tsm_conv1x1_reference,
)

TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-3, atol=1e-3)
# the shapes of tests/test_tsm_conv_pallas.py:23-28: both TPU strategies
SHAPES = [(32, 8, 8, 4, 4), (256, 64, 8, 8, 4), (512, 128, 4, 4, 4),
          (64, 16, 8, 6, 3)]


def _case(seed, c, f, hw, t):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2 * t, hw, hw, c)).astype(np.float32)
    k = rng.standard_normal((1, 1, c, f)).astype(np.float32)
    scale = (1 + 0.2 * rng.standard_normal(f)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(f)).astype(np.float32)
    return x, k, scale, bias


@pytest.mark.parametrize("c,f,n_div,hw,t", SHAPES)
def test_tsm_conv_matches_pallas(c, f, n_div, hw, t):
    x, k, scale, bias = _case(0, c, f, hw, t)
    xj, kj = jnp.asarray(x), jnp.asarray(k)
    want = np.asarray(tsm_conv1x1_pallas(xj, kj, t, n_div))
    xt, kt = torch.from_numpy(x), torch.from_numpy(k)
    np.testing.assert_allclose(tsm_conv1x1(xt, kt, t, n_div).numpy(), want,
                               **TOL)
    want = np.asarray(tsm_conv1x1_bn_relu_pallas(
        xj, kj, jnp.asarray(scale), jnp.asarray(bias), t, n_div))
    got = tsm_conv1x1_bn_relu(xt, kt, torch.from_numpy(scale),
                              torch.from_numpy(bias), t, n_div)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the XLA forms that tap3 and xla run
    for port, jax_fn in ((temporal_shift_conv1x1, jax_shift_conv),
                         (temporal_shift_conv1x1_3tap, jax_shift_conv_3tap)):
        np.testing.assert_allclose(port(xt, kt, t, n_div).numpy(),
                                   np.asarray(jax_fn(xj, kj, t, n_div)),
                                   **TOL)


def test_tsm_conv_gradients_match_jax():
    """jax.grad through the Pallas kernel's custom VJP against autograd
    through the plain version and the two plain XLA forms."""
    t, n_div = 4, 8
    x, k, _, _ = _case(1, 32, 8, 4, t)
    g = np.random.default_rng(2).standard_normal((2 * t, 4, 4, 8))
    g = g.astype(np.float32)

    def loss(x_, k_):
        return (tsm_conv1x1_pallas(x_, k_, t, n_div) * g).sum()

    want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(k))
    for fn in (tsm_conv1x1, temporal_shift_conv1x1,
               temporal_shift_conv1x1_3tap):
        xt = torch.from_numpy(x).requires_grad_()
        kt = torch.from_numpy(k).requires_grad_()
        (fn(xt, kt, t, n_div) * torch.from_numpy(g)).sum().backward()
        for got, w in zip((xt.grad, kt.grad), want):
            np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                       **GRAD_TOL)


def test_tsm_conv_rounds_once_in_bf16():
    """bf16 x: the product and the epilogue in float32, one rounding at
    the end (the JAX kernel rounds before its epilogue)."""
    x, k, scale, bias = _case(3, 64, 16, 4, 4)
    xb = torch.from_numpy(x).bfloat16()
    got = tsm_conv1x1_reference(xb, torch.from_numpy(k).bfloat16(), 4, 8,
                                torch.from_numpy(scale),
                                torch.from_numpy(bias), relu=True)
    xs = temporal_shift_reference(xb.float(), 4, 8)
    want = torch.relu(xs @ torch.from_numpy(k).bfloat16().float().reshape(
        64, 16) * torch.from_numpy(scale) + torch.from_numpy(bias))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.bfloat16())


@pytest.mark.parametrize("n_div,dtype", [(8, np.float32), (4, np.float32),
                                         (8, np.uint8)])
def test_temporal_shift_matches_pallas(n_div, dtype):
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((2 * 4, 3, 3, 16)) * 50).astype(dtype)
    want = np.asarray(temporal_shift_pallas(jnp.asarray(x), 4, n_div))
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(temporal_shift(xt, 4, n_div).numpy(), want)
    np.testing.assert_array_equal(
        temporal_shift(xt.reshape(2, 4, 3, 3, 16), 4, n_div).numpy(),
        want.reshape(2, 4, 3, 3, 16))


def test_temporal_shift_gradient_is_the_reverse_shift():
    """jax.grad of the shift against autograd through the plain version
    and against the reverse shift of the cotangent, exactly."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((8, 2, 2, 16)).astype(np.float32)
    g = rng.standard_normal((8, 2, 2, 16)).astype(np.float32)
    want = np.asarray(jax.grad(lambda a: (jax_temporal_shift(a, 4, 8)
                                          * g).sum())(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    (temporal_shift(xt, 4, 8) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), want)
    np.testing.assert_array_equal(
        temporal_shift(torch.from_numpy(g), 4, 8, reverse=True).numpy(),
        want)


@pytest.mark.parametrize("shape", [(2, 8, 16, 3), (3, 5, 7, 3)])
def test_normalize_frames_matches_pallas(shape):
    """(2, 8, 16, 3) takes the Pallas kernel (768 elements, a multiple of
    384); (3, 5, 7, 3) its XLA fallback. The port has no size limit."""
    u8 = np.random.default_rng(6).integers(0, 256, shape, np.uint8)
    want = np.asarray(normalize_frames_pallas(jnp.asarray(u8)))
    got = normalize_frames(torch.from_numpy(u8))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    ref = normalize_frames_reference(torch.from_numpy(u8), torch.bfloat16)
    assert torch.equal(normalize_frames(torch.from_numpy(u8),
                                        torch.bfloat16), ref)


def test_wrappers_refuse_other_devices():
    x = torch.zeros(8, 2, 2, 32, device="meta")
    w = torch.zeros(32, 64, device="meta")
    for call in (lambda: tsm_conv1x1(x, w, 4),
                 lambda: tsm_conv1x1_bn_relu(x, w, w[0], w[0], 4),
                 lambda: temporal_shift(x, 4),
                 lambda: normalize_frames(x.to(torch.uint8))):
        with pytest.raises(NotImplementedError):
            call()
