"""The port's training ops (K11 stem, K12 bottleneck, K13 trunk) against
the JAX package's Pallas training kernels, on the CPU.

The same numpy inputs from a seed go through the JAX kernel (interpret
mode off the TPU, as the JAX package's own tests run it) and through the
port's entry point, which takes its plain version on CPU tensors (convs
plus explicit batch-stat BatchNorm, differentiated by autograd). Compared
in float32: the forward output and batch statistics at 1e-4 (absolute and
relative; the two sum in different orders, and the Pallas conv1 adds the
shift as a correction term), and every gradient at 2e-4 of its largest
magnitude, as tests/test_tsm_block_train_pallas.py holds the kernels to
their XLA reference.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from video_chapter_generation_tpu.ops import tsm_block_train_pallas as tbt
from video_chapter_generation_tpu.ops.stem_train_pallas import (
    stem_frames_train as jax_stem_frames_train,
    stem_s2d_train as jax_stem_s2d_train,
)
from video_chapter_generation_tpu.ops.tsm_trunk_train_pallas import (
    tsm_trunk_train as jax_tsm_trunk_train,
)
from video_chapter_generation_tpu_torch.ops.stem_train import (
    stem_frames_train,
    stem_s2d_train,
)
from video_chapter_generation_tpu_torch.ops.tsm_block_train import (
    tsm_bottleneck_proj_train,
    tsm_bottleneck_s2_train,
    tsm_bottleneck_train,
)
from video_chapter_generation_tpu_torch.ops.tsm_trunk_train import (
    tsm_trunk_train,
)

T, NDIV, EPS = 4, 8, 1e-5
FWD_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_REL = 2e-4


def _affine(rng, n):
    return [(1.0 + 0.1 * rng.standard_normal(n)).astype(np.float32),
            (0.1 * rng.standard_normal(n)).astype(np.float32)]


def _block_arrays(rng, c, f, co, proj):
    """(w1, w2, w3[, wp], g1, be1, g2, be2, g3, be3[, gp, bep]) in the
    JAX entry's argument order."""
    mk = lambda *s: (rng.standard_normal(s) / np.sqrt(np.prod(s[:-1])))  # noqa: E731
    ws = [mk(c, f), mk(3, 3, f, f), mk(f, co)] + ([mk(c, co)] if proj
                                                   else [])
    aff = _affine(rng, f) + _affine(rng, f) + _affine(rng, co)
    aff += _affine(rng, co) if proj else []
    return [a.astype(np.float32) for a in ws] + aff


def _jax_run(fn, args, cot):
    """(y, stats, grads wrt every argument) of a JAX kernel, one trace."""
    (y, stats), vjp = jax.vjp(fn, *[jnp.asarray(a) for a in args])
    grads = vjp((jnp.asarray(cot), jax.tree_util.tree_map(jnp.zeros_like,
                                                          stats)))
    return y, stats, grads


def _port_run(fn, args, cot, grad_x=True):
    ts = [torch.from_numpy(np.asarray(a)).requires_grad_(
        a.dtype != np.uint8 and (i > 0 or grad_x)) for i, a in enumerate(args)]
    y, stats = fn(*ts)
    (y * torch.from_numpy(cot)).sum().backward()
    return y, stats, [t.grad for t in ts]


def _assert_grads(got, want, names):
    for name, g, w in zip(names, got, want):
        if g is None:
            continue
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-3)
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=GRAD_REL,
                                   atol=GRAD_REL * scale, err_msg=name)


def _assert_forward(y, stats, y_ref, stats_ref):
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref),
                               **FWD_TOL)
    assert len(stats) == len(stats_ref)
    for k, (s, sr) in enumerate(zip(stats, stats_ref)):
        np.testing.assert_allclose(s.numpy(), np.asarray(sr), **FWD_TOL,
                                   err_msg=f"stat{k}")


BLOCK_CASES = {
    # kind: (clips, h, w, c, f, co)
    "plain": (2, 8, 8, 32, 8, 32),
    "plain_ragged": (1, 6, 12, 32, 8, 32),  # W not a multiple of 8
    "proj": (1, 8, 8, 16, 8, 32),
    "s2": (1, 8, 8, 32, 8, 32),
}


@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_block_train_matches_jax(case):
    b, h, w, c, f, co = BLOCK_CASES[case]
    kind = case.split("_")[0]
    rng = np.random.default_rng(21)
    x = (rng.standard_normal((b * T, h, w, c)) * 0.5).astype(np.float32)
    params = _block_arrays(rng, c, f, co, kind != "plain")
    ho, wo = (h // 2, w // 2) if kind == "s2" else (h, w)
    cot = rng.standard_normal((b * T, ho, wo, co)).astype(np.float32)
    jax_fn, port_fn = {
        "plain": (tbt.tsm_bottleneck_train, tsm_bottleneck_train),
        "proj": (tbt.tsm_bottleneck_proj_train, tsm_bottleneck_proj_train),
        "s2": (tbt.tsm_bottleneck_s2_train, tsm_bottleneck_s2_train),
    }[kind]
    y_ref, st_ref, g_ref = _jax_run(
        lambda *a: jax_fn(*a, T, NDIV, EPS), [x] + params, cot)
    y, st, g = _port_run(lambda *a: port_fn(*a, T, NDIV, EPS), [x] + params,
                         cot)
    assert not any(s.requires_grad for s in st)  # statistics are buffers
    _assert_forward(y, st, y_ref, st_ref)
    names = ["dx", "dw1", "dw2", "dw3"] + (["dwp"] if kind != "plain"
                                           else [])
    names += ["dg1", "dbe1", "dg2", "dbe2", "dg3", "dbe3"]
    names += ["dgp", "dbep"] if kind != "plain" else []
    _assert_grads(g, g_ref, names)


def _stem_params(rng):
    w7 = (rng.standard_normal((7, 7, 3, 64)) / np.sqrt(147)).astype(
        np.float32)
    return [w7] + _affine(rng, 64)


@pytest.mark.parametrize("entry", ["u8_s2d", "frames"])
def test_stem_train_matches_jax(entry):
    rng = np.random.default_rng(22)
    params = _stem_params(rng)
    if entry == "u8_s2d":
        x = rng.integers(0, 256, (3, 4, 4, 48)).astype(np.uint8)
        jax_fn = lambda *a: jax_stem_s2d_train(  # noqa: E731
            jnp.asarray(x), *a, EPS, jnp.float32)
        port_fn = lambda *a: stem_s2d_train(  # noqa: E731
            torch.from_numpy(x), *a, EPS, torch.float32)
    else:
        x = rng.standard_normal((3, 16, 16, 3)).astype(np.float32)
        jax_fn = lambda *a: jax_stem_frames_train(  # noqa: E731
            jnp.asarray(x), *a, EPS, jnp.float32)
        port_fn = lambda *a: stem_frames_train(  # noqa: E731
            torch.from_numpy(x), *a, EPS, torch.float32)
    cot = rng.standard_normal((3, 4, 4, 64)).astype(np.float32)
    y_ref, st_ref, g_ref = _jax_run(jax_fn, params, cot)
    y, st, g = _port_run(port_fn, params, cot)
    _assert_forward(y, st, y_ref, st_ref)
    _assert_grads(g, g_ref, ["dw7", "dgamma", "dbeta"])


def test_trunk_train_matches_jax():
    """proj -> plain -> s2 -> plain: every link kind of the ResNet50 trunk."""
    rng = np.random.default_rng(23)
    kinds = ("proj", "plain", "s2", "plain")
    blocks, c = [], 16
    for kind, f in zip(kinds, (8, 8, 16, 16)):
        co = 4 * f if kind != "plain" else c
        blocks.append(_block_arrays(rng, c, f, co, kind != "plain"))
        c = co
    x = (rng.standard_normal((T, 8, 8, 16)) * 0.5).astype(np.float32)
    cot = rng.standard_normal((T, 4, 4, 64)).astype(np.float32)
    sizes = [len(b) for b in blocks]

    def split(flat):
        out, i = [], 0
        for n in sizes:
            out.append(tuple(flat[i:i + n]))
            i += n
        return out

    flat = [a for blk in blocks for a in blk]
    y_ref, st_ref, g_ref = _jax_run(
        lambda x_, *f_: jax_tsm_trunk_train(x_, tuple(split(f_)), kinds, T,
                                            NDIV, EPS), [x] + flat, cot)
    y, st, g = _port_run(
        lambda x_, *f_: tsm_trunk_train(x_, split(f_), kinds, T, NDIV, EPS),
        [x] + flat, cot)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref),
                               **FWD_TOL)
    for bi, (s, sr) in enumerate(zip(st, st_ref)):
        _assert_forward(torch.zeros(1), s, np.zeros(1), sr)
    _assert_grads(g, g_ref, [f"g{i}" for i in range(len(g))])


def test_training_kernel_refuses_no_shift():
    """The training bottleneck kernel shifts in time: a block without a
    segment length is refused before anything launches, where it would
    otherwise divide by zero in the kernel's frame arithmetic."""
    from video_chapter_generation_tpu_torch.ops.tsm_block_train import _check

    x = torch.zeros(4, 8, 8, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="n_segment"):
        _check(x, 64, 64, 1, 0, NDIV, False)
