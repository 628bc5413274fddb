"""The port's block-sparse (BigBird ITC) attention against the JAX package
on the CPU, in float32.

The same numpy inputs go through the JAX `block_sparse_attention` in its
XLA gather form (impl="gather") and through its Pallas kernel K10 in
interpret mode (impl="kernel", as tests/test_sparse_attention.py runs
it), and through the port's `block_sparse_attention`, whose middle
blocks take `sparse_band_attention`'s plain version on CPU tensors.
Tolerance 1e-5 absolute and relative: the three sum the same float32
products in different orders and the kernel divides by the softmax sum
after the value product.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from video_chapter_generation_tpu.models.sparse_attention import (
    _random_block_map as jax_random_block_map,
    block_sparse_attention as jax_block_sparse_attention,
)
from video_chapter_generation_tpu.ops.sparse_attention_pallas import (
    penalty_for_structured_ids,
    sparse_band_attention_pallas,
    structured_ids as jax_structured_ids,
)
from video_chapter_generation_tpu_torch.models.sparse_attention import (
    _random_block_map,
    block_sparse_attention,
)
from video_chapter_generation_tpu_torch.ops.sparse_attention import (
    sparse_band_attention,
    sparse_band_attention_reference,
    structured_ids,
)

TOL = dict(rtol=1e-5, atol=1e-5)
L, BS, H, HD = 256, 16, 2, 16


def _qkv(seed, b=2, l=L):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, l, H, HD)).astype(np.float32)
            for _ in range(3)]


def _mask(b, l, padded):
    mask = np.ones((b, l), np.int32)
    if padded:
        mask[1, 150:] = 0
        mask[0, l - 9:] = 0
    return mask


def _port(q, k, v, mask, **kw):
    t = [torch.from_numpy(a) for a in (q, k, v, mask)]
    return block_sparse_attention(*t, block_size=BS, **kw).numpy()


def _jax(q, k, v, mask, impl, **kw):
    out = jax_block_sparse_attention(
        *[jnp.asarray(a) for a in (q, k, v, mask)], block_size=BS,
        impl=impl, **kw)
    return np.asarray(out)


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("r", [0, 1, 2])
@pytest.mark.parametrize("impl", ["gather", "kernel"])
def test_block_sparse_matches_jax(impl, r, padded):
    q, k, v = _qkv(10 + r)
    mask = _mask(2, L, padded)
    got = _port(q, k, v, mask, num_rand_blocks=r)
    want = _jax(q, k, v, mask, impl, num_rand_blocks=r)
    np.testing.assert_allclose(got, want, **TOL)
    if padded:  # the sparse path zeroes padded query rows
        assert not got[1, 150:].any()


@pytest.mark.parametrize("impl", ["gather", "kernel"])
def test_colliding_rand_map_is_double_counted(impl):
    """An injected map whose random blocks collide with the window and
    the globals: HF counts such a key block twice, and so must both."""
    q, k, v = _qkv(20)
    mask = _mask(2, L, True)
    nb = L // BS
    rand_map = np.zeros((nb, 2), np.int32)
    for qb in range(nb):
        rand_map[qb] = [0, min(qb + 1, nb - 1)]
    kw = dict(num_rand_blocks=2, rand_map=rand_map)
    got = _port(q, k, v, mask, **kw)
    np.testing.assert_allclose(got, _jax(q, k, v, mask, impl, **kw), **TOL)
    # and it differs from the deduplicated domain of a non-colliding map
    other = _port(q, k, v, mask, num_rand_blocks=2)
    assert not np.allclose(got, other, **TOL)


@pytest.mark.parametrize("r", [0, 1])
def test_short_sequence_falls_back_to_full_attention(r):
    """nb <= 5 + 2r: full attention, and padded query rows keep their
    values (no zeroing on this path; the JAX package's
    models/sparse_attention.py:114-115)."""
    l = BS * (5 + 2 * r)
    q, k, v = _qkv(30, l=l)
    mask = np.ones((2, l), np.int32)
    mask[1, l - 20:] = 0
    got = _port(q, k, v, mask, num_rand_blocks=r)
    np.testing.assert_allclose(
        got, _jax(q, k, v, mask, "gather", num_rand_blocks=r), **TOL)
    assert np.abs(got[1, l - 20:]).min() > 0


@pytest.mark.parametrize("nb,r,seed", [(16, 1, 0), (16, 2, 0), (48, 3, 0),
                                       (48, 3, 7), (9, 3, 1)])
def test_random_block_map_equals_jax(nb, r, seed):
    np.testing.assert_array_equal(_random_block_map(nb, r, seed),
                                  jax_random_block_map(nb, r, seed))


@pytest.mark.parametrize("r", [0, 2])
def test_structured_ids_equal_jax(r):
    nb = 16
    rand_map = jax_random_block_map(nb, r, 3) if r else None
    for got, want in zip(structured_ids(nb, rand_map),
                         jax_structured_ids(nb, rand_map)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("r", [0, 2])
def test_band_reference_matches_the_pallas_kernel(r):
    """sparse_band_attention_reference against JAX's K10 (interpret mode)
    on the same structured inputs: the middle blocks alone."""
    q, k, v = _qkv(40 + r)
    mask = _mask(2, L, True)
    nb = L // BS
    rand_map = jax_random_block_map(nb, r, 0) if r else None
    ids, valid = structured_ids(nb, rand_map)
    pen = penalty_for_structured_ids(jnp.asarray(mask), ids, valid, BS)
    rand_ids = ids[:, 5:]
    want = sparse_band_attention_pallas(
        jnp.asarray(q[:, BS:-BS]), jnp.asarray(k), jnp.asarray(v), pen,
        jnp.asarray(rand_ids), BS, interpret=True)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    got = sparse_band_attention_reference(
        t(q[:, BS:-BS]), t(k), t(v), t(mask), t(ids), t(valid), BS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_wrapper_on_cpu_takes_the_plain_version():
    """A CPU tensor takes the plain version (no launch counted): `out`
    receives rows bs..L-bs, the result is that slice, and the first and
    last blocks stay as they were."""
    q, k, v = [torch.from_numpy(a) for a in _qkv(50)]
    mask = torch.from_numpy(_mask(2, L, True))
    ids, valid = [torch.from_numpy(a) for a in structured_ids(L // BS, None)]
    before = sparse_band_attention.launches
    out = torch.zeros_like(q)
    view = sparse_band_attention(q[:, BS:-BS], k, v, mask, ids, valid, BS,
                                 out)
    assert sparse_band_attention.launches == before
    assert torch.equal(view, sparse_band_attention_reference(
        q[:, BS:-BS], k, v, mask, ids, valid, BS))
    assert torch.equal(out[:, BS:-BS], view)
    assert not out[:, :BS].any() and not out[:, -BS:].any()
    with pytest.raises(NotImplementedError):
        sparse_band_attention(q.to("meta")[:, BS:-BS], k.to("meta"),
                              v.to("meta"), mask, ids, valid, BS,
                              out.to("meta"))
