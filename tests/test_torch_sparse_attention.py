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
    require_structured,
    sparse_band_attention,
    sparse_band_attention_reference,
    structured_ids,
)

TOL = dict(rtol=1e-5, atol=1e-5)
L, BS, H, HD = 256, 16, 2, 16


def _qkv(seed, b=2, l=L, hd=HD):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, l, H, hd)).astype(np.float32)
            for _ in range(3)]


def _mask(b, l, padded):
    mask = np.ones((b, l), np.int32)
    if padded:
        mask[1, l * 150 // L:] = 0  # whole blocks padded before the last
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


# (r, bs, hd, nb): the first two at this file's L, BS and HD; then other
# block sizes and head dims that the card's kernels take, with r 0, 1 and
# 5 (P 5, 6 and 10), each at a small L
@pytest.mark.parametrize("r,bs,hd,nb", [
    pytest.param(0, BS, HD, L // BS, id="0"),
    pytest.param(2, BS, HD, L // BS, id="2"),
    pytest.param(1, 16, 48, 9, id="bs16-hd48-r1"),
    pytest.param(5, 16, 16, 13, id="bs16-hd16-r5"),
    pytest.param(0, 32, 16, 6, id="bs32-hd16-r0"),
    pytest.param(1, 32, 48, 7, id="bs32-hd48-r1"),
    pytest.param(5, 32, 48, 12, id="bs32-hd48-r5"),
])
def test_band_reference_matches_the_pallas_kernel(r, bs, hd, nb):
    """sparse_band_attention_reference against JAX's K10 (interpret mode)
    on the same structured inputs: the middle blocks alone."""
    l = nb * bs
    q, k, v = _qkv(40 + r, l=l, hd=hd)
    mask = _mask(2, l, True)
    rand_map = jax_random_block_map(nb, r, 0) if r else None
    ids, valid = structured_ids(nb, rand_map)
    pen = penalty_for_structured_ids(jnp.asarray(mask), ids, valid, bs)
    rand_ids = ids[:, 5:]
    want = sparse_band_attention_pallas(
        jnp.asarray(q[:, bs:-bs]), jnp.asarray(k), jnp.asarray(v), pen,
        jnp.asarray(rand_ids), bs, interpret=True)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    got = sparse_band_attention_reference(
        t(q[:, bs:-bs]), t(k), t(v), t(mask), t(ids), t(valid), bs)
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


def _online_softmax_halves(q_mid, k, v, mask, ids, valid, bs):
    """The serving-shape kernel's order in plain torch (float32): per
    query block, one online softmax over parts [0, h) and one over [h, P),
    h = ceil(P / 2), each in the table's order with the running max and
    sum of csrc/sparse_attention.cu's wgmma kernel, then the merge: both
    contexts and sums rescaled to the larger max, the context divided by
    the merged sum."""
    b, lq, h, hd = q_mid.shape
    nbq, p = ids.shape
    scale = 1.0 / np.sqrt(hd)
    qs = q_mid.reshape(b, nbq, bs, h, hd).float()
    out = torch.empty(b, nbq, bs, h, hd)
    half = (p + 1) // 2
    for qb in range(nbq):
        states = []
        for parts in (range(half), range(half, p)):
            m = torch.full((b, h, bs), -1e30)
            l = torch.zeros(b, h, bs)
            o = torch.zeros(b, h, bs, hd)
            for j in parts:
                blk = int(ids[qb, j])
                keys = slice(blk * bs, (blk + 1) * bs)
                pen = (1.0 - mask[:, keys].float()
                       * float(valid[qb, j])) * -10000.0
                s = torch.einsum("bqhd,bkhd->bhqk", qs[:, qb],
                                 k[:, keys].float()) * scale
                s = s + pen[:, None, None, :]
                m_new = torch.maximum(m, s.amax(-1))
                a = torch.exp(m - m_new)
                e = torch.exp(s - m_new[..., None])
                l = l * a + e.sum(-1)
                o = o * a[..., None] + torch.einsum("bhqk,bkhd->bhqd", e,
                                                    v[:, keys].float())
                m = m_new
            states.append((m, l, o))
        (ma, la, oa), (mb, lb, ob) = states
        mm = torch.maximum(ma, mb)
        fa, fb = torch.exp(ma - mm), torch.exp(mb - mm)
        ctx = (oa * fa[..., None] + ob * fb[..., None]) / (
            la * fa + lb * fb)[..., None]
        out[:, qb] = ctx.permute(0, 2, 1, 3)
    return out.reshape(b, lq, h, hd)


@pytest.mark.parametrize("r", [0, 1, 3])
def test_two_half_online_softmax_matches_the_reference(r):
    """The wgmma kernel's part order (two online softmaxes over the halves
    of the parts, merged) computes the plain version's function: equal to
    sparse_band_attention_reference at the file's tolerance, padded keys
    and a colliding random map included."""
    q, k, v = [torch.from_numpy(a) for a in _qkv(60 + r)]
    mask = torch.from_numpy(_mask(2, L, True))
    nb = L // BS
    rand_map = None
    if r:
        rand_map = np.random.default_rng(r).integers(0, nb, (nb, r)).astype(
            np.int32)
    ids, valid = [torch.from_numpy(a) for a in structured_ids(nb, rand_map)]
    got = _online_softmax_halves(q[:, BS:-BS], k, v, mask, ids, valid, BS)
    want = sparse_band_attention_reference(q[:, BS:-BS], k, v, mask, ids,
                                           valid, BS)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("r", [0, 3])
def test_require_structured_refuses_other_tables(r):
    """The wgmma kernel derives parts 0-4 from the structure: a table whose
    first five columns are structured_ids' passes (and is remembered until
    it is written to), any other raises ValueError before a launch."""
    nb = 12
    rand_map = (np.random.default_rng(r).integers(0, nb, (nb, r)).astype(
        np.int32) if r else None)
    ids = torch.from_numpy(structured_ids(nb, rand_map)[0])
    require_structured(ids, nb)
    require_structured(ids, nb)
    ids[3, 1] += 1
    with pytest.raises(ValueError, match="structured_ids"):
        require_structured(ids, nb)
    with pytest.raises(ValueError, match="structured_ids"):
        require_structured(torch.from_numpy(structured_ids(nb + 1, None)[0]),
                           nb)
