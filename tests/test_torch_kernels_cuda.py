"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips without a CUDA device (here, on the CPU).
On a machine with an H100 and nvcc: python -m pytest -m cuda
tests/test_torch_kernels_cuda.py. chip_smoke.py holds the same kernels
at every main-path shape; these are quick shapes for iterating.
Bands: cosine >= 0.999 and mean relative error <= 1e-2 in bf16 (the
kernel accumulates in float32, the plain version rounds each conv output
to bf16 first).
"""

import pytest
import torch

from video_chapter_generation_tpu_torch.ops.stem import (
    stem_s2d,
    stem_s2d_reference,
)
from video_chapter_generation_tpu_torch.ops.tsm_block import (
    tsm_bottleneck,
    tsm_bottleneck_reference,
    tsm_bottleneck_s2,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, ref):
    got, ref = got.float().flatten(), ref.float().flatten()
    cos = torch.nn.functional.cosine_similarity(got, ref, dim=0).item()
    mrel = ((got - ref).abs().mean() / ref.abs().mean()).item()
    assert cos >= 0.999 and mrel <= 1e-2, (cos, mrel)


def test_stem_s2d_kernel(dev):
    g = torch.Generator().manual_seed(0)
    s4 = torch.randint(0, 256, (4, 56, 56, 48), generator=g,
                       dtype=torch.uint8).to(dev)
    w7 = (torch.randn(7, 7, 3, 64, generator=g) * 0.05).to(dev)
    s, b = torch.rand(64, generator=g).to(dev) + 0.5, torch.zeros(64,
                                                                  device=dev)
    before = stem_s2d.launches
    got = stem_s2d(s4, w7, s, b)
    torch.cuda.synchronize()
    assert stem_s2d.launches == before + 1
    _close(got, stem_s2d_reference(s4, w7, s, b))


@pytest.mark.parametrize("stride,proj", [(1, False), (1, True), (2, True)])
def test_tsm_bottleneck_kernel(dev, stride, proj):
    g = torch.Generator().manual_seed(1)
    t, c, f = 8, 256, 64
    cout = 4 * f if proj else c
    bf = torch.bfloat16
    x = torch.relu(torch.randn(2 * t, 14, 14, c, generator=g)).to(dev, bf)
    mk = lambda *s: (torch.randn(*s, generator=g) * 0.05).to(dev, bf)  # noqa: E731
    one = lambda n: torch.rand(n, generator=g).to(dev) + 0.5  # noqa: E731
    zero = lambda n: torch.zeros(n, device=dev)  # noqa: E731
    args = (x, mk(c, f), mk(3, 3, f, f), mk(f, cout), one(f), zero(f),
            one(f), zero(f), one(cout), zero(cout))
    wp = (mk(c, cout), one(cout), zero(cout)) if proj else (None,) * 3
    if stride == 2:
        got = tsm_bottleneck_s2(*args, *wp, t)
    else:
        got = tsm_bottleneck(*args, t, 8, *wp)
    torch.cuda.synchronize()
    _close(got, tsm_bottleneck_reference(*args, t, 8, *wp, stride=stride))


# --- training kernels (K11-K13): forward, batch stats and every gradient ---
# Bands: outputs and stats cos >= 0.999 / mean_rel <= 1e-2 (bf16 rounding
# at different places); gradients cos >= 0.999 / mean_rel <= 3e-2 (a dozen
# bf16 GEMMs and BN backward reductions deep, summed in another order).


def _grad_run(fn, x, params, dy):
    xs = x.detach().requires_grad_(x.is_floating_point())
    ps = [None if p is None else p.detach().clone().requires_grad_()
          for p in params]
    y, stats = fn(xs, ps)
    wrt = ([xs] if xs.requires_grad else []) + [p for p in ps if p is not None]
    return y, stats, torch.autograd.grad(y, wrt, dy)


def _grad_close(got, ref):
    got, ref = got.float().flatten(), ref.float().flatten()
    cos = torch.nn.functional.cosine_similarity(got, ref, dim=0).item()
    mrel = ((got - ref).abs().mean() / ref.abs().mean()).item()
    assert cos >= 0.999 and mrel <= 3e-2, (cos, mrel)


def _block_params(g, dev, c, f, co, proj):
    mk = lambda *s: (torch.randn(*s, generator=g) / s[-2] ** 0.5).to(dev)  # noqa: E731
    aff = lambda n: ((1 + 0.1 * torch.randn(n, generator=g)).to(dev),  # noqa: E731
                     (0.1 * torch.randn(n, generator=g)).to(dev))
    g1, be1 = aff(f)
    g2, be2 = aff(f)
    g3, be3 = aff(co)
    gp, bep = aff(co) if proj else (None, None)
    return [mk(c, f), (torch.randn(3, 3, f, f, generator=g)
                       / (9 * f) ** 0.5).to(dev),
            mk(f, co), mk(c, co) if proj else None,
            g1, be1, g2, be2, g3, be3, gp, bep]


@pytest.mark.parametrize("stride,proj,c,f", [(1, False, 256, 64),
                                            (1, True, 64, 64),
                                            (2, True, 256, 128)])
def test_block_train_kernel(dev, stride, proj, c, f):
    from video_chapter_generation_tpu_torch.ops.tsm_block_train import (
        _block,
        block_train_bwd,
        block_train_fwd,
        tsm_block_train_reference,
    )

    g = torch.Generator().manual_seed(3)
    t = 8
    co = 4 * f if proj else c
    x = torch.relu(torch.randn(2 * t, 14, 14, c, generator=g)).to(
        dev, torch.bfloat16)
    params = _block_params(g, dev, c, f, co, proj)
    ho = 14 // stride
    dy = torch.randn(2 * t, ho, ho, co, generator=g).to(dev, torch.bfloat16)

    def kern(xs, ps):
        return _block(xs, ps, stride, t, 8, 1e-5)

    def plain(xs, ps):
        return tsm_block_train_reference(
            xs, ps[0], ps[1], ps[2], ps[4], ps[5], ps[6], ps[7], ps[8],
            ps[9], t, 8, 1e-5, ps[3], ps[10], ps[11], stride)

    f0, b0 = block_train_fwd.launches, block_train_bwd.launches
    y, st, gk = _grad_run(kern, x, params, dy)
    torch.cuda.synchronize()
    assert (block_train_fwd.launches, block_train_bwd.launches) == (f0 + 1,
                                                                    b0 + 1)
    yr, str_, gr = _grad_run(plain, x, params, dy)
    _close(y, yr)
    for a, b in zip(st, str_):
        _close(a, b)
    for a, b in zip(gk, gr):
        _grad_close(a, b)


def test_stem_train_kernel(dev):
    from video_chapter_generation_tpu_torch.ops.stem_train import (
        stem_s2d_train,
        stem_train_bwd,
        stem_train_fwd,
    )
    from video_chapter_generation_tpu_torch.ops.preprocess import (
        depth_to_space4,
        normalize_frames,
    )
    from video_chapter_generation_tpu_torch.ops.stem_train import (
        stem_train_reference,
    )

    g = torch.Generator().manual_seed(4)
    s4 = torch.randint(0, 256, (8, 28, 28, 48), generator=g,
                       dtype=torch.uint8).to(dev)
    params = [(torch.randn(7, 7, 3, 64, generator=g) / 147 ** 0.5).to(dev),
              (1 + 0.1 * torch.randn(64, generator=g)).to(dev),
              (0.1 * torch.randn(64, generator=g)).to(dev)]
    dy = torch.randn(8, 28, 28, 64, generator=g).to(dev, torch.bfloat16)
    f0, b0 = stem_train_fwd.launches, stem_train_bwd.launches
    y, st, gk = _grad_run(lambda xs, ps: stem_s2d_train(xs, *ps), s4, params,
                          dy)
    torch.cuda.synchronize()
    assert (stem_train_fwd.launches, stem_train_bwd.launches) == (f0 + 1,
                                                                  b0 + 1)
    frames = normalize_frames(depth_to_space4(s4), torch.bfloat16)
    yr, str_, gr = _grad_run(
        lambda xs, ps: stem_train_reference(frames, *ps), s4, params, dy)
    _close(y, yr)
    for a, b in zip(st, str_):
        _close(a, b)
    for a, b in zip(gk, gr):
        _grad_close(a, b)


def test_trunk_train_kernel(dev):
    from video_chapter_generation_tpu_torch.ops.tsm_block_train import _block
    from video_chapter_generation_tpu_torch.ops.tsm_trunk_train import (
        STRIDES,
        recompute_p,
        trunk_reference,
        tsm_trunk_train,
        unpack,
    )

    g = torch.Generator().manual_seed(5)
    t = 8
    kinds = ("proj", "plain", "s2", "plain")
    blocks, c = [], 64
    for kind, f in zip(kinds, (64, 64, 128, 128)):
        proj = kind != "plain"
        co = 4 * f if proj else c
        p = _block_params(g, dev, c, f, co, proj)
        blocks.append(p if proj else [p[i] for i in (0, 1, 2, 4, 5, 6, 7,
                                                      8, 9)])
        c = co
    x = torch.relu(torch.randn(2 * t, 16, 16, 64, generator=g)).to(
        dev, torch.bfloat16)
    dy = torch.randn(2 * t, 8, 8, 512, generator=g).to(dev, torch.bfloat16)
    flat = [p for b in blocks for p in b]

    def regroup(ps):
        out, i = [], 0
        for kind in kinds:
            k = 9 if kind == "plain" else 12
            out.append(ps[i:i + k])
            i += k
        return out

    def chain(xs, ps):
        stats = []
        for p, kind in zip(regroup(ps), kinds):
            xs, st = _block(xs, unpack(p, kind), STRIDES[kind], t, 8, 1e-5)
            stats.append(st)
        return xs, stats

    def kept_after_forward(fn):
        """Bytes the forward leaves on the card for its backward, and the
        (y, stats, grads) of forward plus backward."""
        xs = x.detach().clone().requires_grad_()
        ps = [p.detach().clone().requires_grad_() for p in flat]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        y, stats = fn(xs, ps)
        kept = torch.cuda.memory_allocated(dev) - base
        return kept, (y, stats, torch.autograd.grad(y, [xs] + ps, dy))

    r0 = recompute_p.launches
    kept_t, (y, st, gk) = kept_after_forward(
        lambda xs, ps: tsm_trunk_train(xs, regroup(ps), kinds, t))
    torch.cuda.synchronize()
    assert recompute_p.launches == r0 + len(kinds)
    # the recomputed p is the forward's p: the trunk agrees bit for bit
    # with the chain of per-block Functions, and keeps no p (each block's
    # p has the shape of its output)
    kept_c, (yc, stc, gc) = kept_after_forward(chain)
    assert torch.equal(y, yc)
    assert all(torch.equal(a, b) for s, sc in zip(st, stc)
               for a, b in zip(s, sc))
    assert all(torch.equal(a, b) for a, b in zip(gk, gc))
    # two blocks at 16 x 16 x 256 and two at 8 x 8 x 512, 2t frames, bf16
    p_bytes = 2 * (2 * t) * (16 * 16 * 256 + 8 * 8 * 512) * 2
    # (less up to 1 MiB a block: the caching allocator may hand a tensor a
    # cached block up to 1 MiB larger than it asked for)
    assert kept_c - kept_t >= p_bytes - len(kinds) * 2 ** 20, (
        kept_c, kept_t, p_bytes)
    yr, str_, gr = _grad_run(
        lambda xs, ps: trunk_reference(xs, regroup(ps), kinds, t), x, flat,
        dy)
    _close(y, yr)
    for a, b in zip(st, str_):
        for u, v in zip(a, b):
            _close(u, v)
    # four blocks of batch-stat BN amplify the two versions' rounding
    # differences, so the trunk's gradients drift further than one
    # block's (each block is held to the tighter band above)
    for a, b in zip(gk, gr):
        got, ref = a.float().flatten(), b.float().flatten()
        assert torch.nn.functional.cosine_similarity(got, ref, dim=0) >= 0.99


def test_training_kernels_are_deterministic(dev):
    """No float atomics: two runs of a block's forward and backward agree
    bit for bit (batch-stat BN would amplify any last-bit difference)."""
    from video_chapter_generation_tpu_torch.ops.tsm_block_train import _block

    g = torch.Generator().manual_seed(6)
    x = torch.relu(torch.randn(16, 14, 14, 256, generator=g)).to(
        dev, torch.bfloat16)
    params = _block_params(g, dev, 256, 128, 512, True)
    dy = torch.randn(16, 7, 7, 512, generator=g).to(dev, torch.bfloat16)
    runs = [_grad_run(lambda xs, ps: _block(xs, ps, 2, 8, 8, 1e-5), x, params,
                      dy) for _ in range(2)]
    (y0, s0, g0), (y1, s1, g1) = runs
    assert torch.equal(y0, y1)
    assert all(torch.equal(a, b) for a, b in zip(s0, s1))
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
