"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips without a CUDA device (here, on the CPU).
On a machine with an H100 and nvcc: python -m pytest -m cuda
tests/test_torch_kernels_cuda.py. chip_smoke.py holds the same kernels
at every main-path shape; these are quick shapes for iterating.
Bands: cosine >= 0.999 and mean relative error <= 1e-2 in bf16 (the
kernel accumulates in float32, the plain version rounds each conv output
to bf16 first).
"""

import json

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


# (frames, px): 224 px with many bands of one strip each (2 frames), bands
# of several strips (16), a whole frame a band (133: a second wave with
# one frame); 32 and 64 px; 36 px, whose last strip holds one cell row;
# frames wider than 64 cells, in column chunks: 260 px (65 cells, an odd
# count, one seam) and 320 px (80 cells)
STEM_SHAPES = [(2, 224), (16, 224), (133, 224), (5, 32), (64, 64), (3, 36),
               (8, 260), (8, 320)]


@pytest.mark.parametrize("n,px", STEM_SHAPES)
def test_stem_s2d_kernel(dev, n, px):
    from video_chapter_generation_tpu_torch.ops.stem import bn_relu_maxpool

    g = torch.Generator().manual_seed(0)
    s4 = torch.randint(0, 256, (n, px // 4, px // 4, 48), generator=g,
                       dtype=torch.uint8).to(dev)
    w7 = (torch.randn(7, 7, 3, 64, generator=g) * 0.05).to(dev)
    s = torch.rand(64, generator=g).to(dev) + 0.5
    s[::5] *= -1  # negative folded BN scales: the kernel pools them flipped
    b = (torch.randn(64, generator=g) * 0.1).to(dev)
    before = (stem_s2d.launches, bn_relu_maxpool.launches)
    got = stem_s2d(s4, w7, s, b)
    torch.cuda.synchronize()
    # one launch, the pool fused
    assert (stem_s2d.launches, bn_relu_maxpool.launches) == (
        before[0] + 1, before[1])
    _close(got, stem_s2d_reference(s4, w7, s, b))
    assert torch.equal(got, stem_s2d(s4, w7, s, b))


def _bottleneck_args(dev, seed, stride, c, f, cout, hw, proj=None):
    """Inputs of one bottleneck: (x, w1, w2, w3, s1, b1, s2, b2, s3, b3)
    and (wp, sp, bp), the projection where proj, by default where
    cout != c or stride 2."""
    g = torch.Generator().manual_seed(seed)
    bf = torch.bfloat16
    x = torch.relu(torch.randn(16, hw, hw, c, generator=g)).to(dev, bf)
    mk = lambda *s: (torch.randn(*s, generator=g) * 0.05).to(dev, bf)  # noqa: E731
    one = lambda n: torch.rand(n, generator=g).to(dev) + 0.5  # noqa: E731
    zero = lambda n: (torch.randn(n, generator=g) * 0.1).to(dev)  # noqa: E731
    args = (x, mk(c, f), mk(3, 3, f, f), mk(f, cout), one(f), zero(f),
            one(f), zero(f), one(cout), zero(cout))
    if proj is None:
        proj = stride == 2 or cout != c
    wp = (mk(c, cout), one(cout), zero(cout)) if proj else (None,) * 3
    return args, wp


def _bottleneck(stride, args, wp, t=8):
    if stride == 2:
        return tsm_bottleneck_s2(*args, *wp, t)
    return tsm_bottleneck(*args, t, 8, *wp)


# every block class of ResNet-50 at small spatial sizes: layer 1's block0
# (C 64, projection), the plain blocks of F 64-512 (7x7, 9x9, 5x5: odd
# widths), the stride-2 block0s into layers 2-4 (14 -> 7, 13 -> 7, 7 ->
# 4); and a stride-1 projection with Cout == C (four k-blocks of x in
# conv3's tile)
BLOCK_CLASSES = [(1, 64, 64, 256, 14, None), (1, 256, 64, 256, 14, None),
                 (1, 256, 64, 256, 5, None), (1, 512, 128, 512, 9, None),
                 (1, 1024, 256, 1024, 7, None),
                 (1, 2048, 512, 2048, 7, None),
                 (2, 256, 128, 512, 14, None), (2, 512, 256, 1024, 13, None),
                 (2, 1024, 512, 2048, 7, None), (1, 256, 64, 256, 14, True)]


@pytest.mark.parametrize("stride,c,f,cout,hw,proj", BLOCK_CLASSES)
def test_tsm_bottleneck_kernel(dev, stride, c, f, cout, hw, proj):
    args, wp = _bottleneck_args(dev, 1, stride, c, f, cout, hw, proj)
    fn = tsm_bottleneck_s2 if stride == 2 else tsm_bottleneck
    before = fn.launches
    got = _bottleneck(stride, args, wp)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    ho = (hw - 1) // stride + 1
    assert got.shape == (16, ho, ho, cout)
    _close(got, tsm_bottleneck_reference(*args, 8, 8, *wp, stride=stride))


@pytest.mark.parametrize("stride,c,f,cout,hw", [(1, 64, 64, 256, 14),
                                                (1, 1024, 256, 1024, 7),
                                                (2, 512, 256, 1024, 13)])
def test_tsm_bottleneck_runs_are_bitwise_equal(dev, stride, c, f, cout, hw):
    """Two runs of K2/K3 or K4 on the same inputs agree bit for bit."""
    args, wp = _bottleneck_args(dev, 2, stride, c, f, cout, hw)
    first = _bottleneck(stride, args, wp)
    second = _bottleneck(stride, args, wp)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("stride,c,f,cout,hw", [(1, 256, 64, 256, 14),
                                                (2, 512, 256, 1024, 13)])
def test_tsm_bottleneck_on_a_second_card(dev, stride, c, f, cout, hw):
    """A kernel launches on its tensor's device: a K2/K3 (K4) block on
    cuda:1 with cuda:0 current equals the same block on cuda:0 bit for
    bit, the frames of a K6 normalize likewise (ops/_calls.py; the
    per-device caches of csrc/hopper_gemm.cuh and csrc/frame_ops.cu)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from video_chapter_generation_tpu_torch.ops.preprocess import (
        normalize_frames,
    )

    d0, d1 = torch.device("cuda", 0), torch.device("cuda", 1)
    args, wp = _bottleneck_args(d0, 4, stride, c, f, cout, hw)
    move = lambda ts: [None if t is None else t.to(d1) for t in ts]  # noqa: E731
    u8 = torch.randint(0, 256, (4, 16, 64, 64, 3), dtype=torch.uint8,
                       generator=torch.Generator().manual_seed(5))
    with torch.cuda.device(d0):
        ref = _bottleneck(stride, args, wp)
        got = _bottleneck(stride, move(args), move(wp))
        # the second card first: its per-device caches fill on cuda:1
        norm1 = normalize_frames(u8.to(d1), torch.bfloat16)
        norm0 = normalize_frames(u8.to(d0), torch.bfloat16)
    torch.cuda.synchronize(d0)
    torch.cuda.synchronize(d1)
    assert got.device == d1 and norm1.device == d1
    assert torch.equal(got.cpu(), ref.cpu())
    assert torch.equal(norm1.cpu(), norm0.cpu())


def test_tsm_bottleneck_refuses_narrow_widths(dev):
    """C % 64 != 0 raises on the card (no plain fallback)."""
    args, wp = _bottleneck_args(dev, 3, 1, 96, 64, 256, 7)
    with pytest.raises(ValueError, match="multiples of 64"):
        _bottleneck(1, args, wp)


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
                                            (2, True, 256, 128),
                                            (1, False, 2048, 512),
                                            (2, True, 1024, 512)])
def test_block_train_kernel(dev, stride, proj, c, f):
    from video_chapter_generation_tpu_torch.ops.tsm_block_train import (
        _block,
        block_train_bwd,
        block_train_fwd,
        finale_bwd,
        finale_fwd,
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

    counters = (block_train_fwd, block_train_bwd, finale_fwd, finale_bwd)
    before = [fn.launches for fn in counters]
    y, st, gk = _grad_run(kern, x, params, dy)
    torch.cuda.synchronize()
    assert [fn.launches - b for fn, b in zip(counters, before)] == [1] * 4
    yr, str_, gr = _grad_run(plain, x, params, dy)
    _close(y, yr)
    for a, b in zip(st, str_):
        _close(a, b)
    for a, b in zip(gk, gr):
        _grad_close(a, b)


# (entry, frames, px): u8 s2d cells at 112 px (sps 2) and 224 px with few
# frames (bands of one strip), 36 px (a one-row last strip, one stage a
# strip); normalized frames (stem_frames_train) and float s2d cells
STEM_TRAIN_CASES = [("u8", 8, 112), ("u8", 2, 224), ("u8", 5, 36),
                    ("frames", 4, 64), ("float_s2d", 3, 96),
                    ("u8", 8, 260), ("frames", 8, 320), ("u8", 3, 320)]


def _stem_train_inputs(g, dev, entry, n, px):
    from video_chapter_generation_tpu_torch.ops.preprocess import (
        depth_to_space4,
        normalize_frames,
    )

    s4 = torch.randint(0, 256, (n, px // 4, px // 4, 48), generator=g,
                       dtype=torch.uint8).to(dev)
    frames = normalize_frames(depth_to_space4(s4), torch.bfloat16)
    if entry == "frames":
        x = frames
    elif entry == "float_s2d":
        x = frames.reshape(n, px // 4, 4, px // 4, 4, 3).permute(
            0, 1, 3, 2, 4, 5).reshape(n, px // 4, px // 4, 48).float()
    else:
        x = s4
    params = [(torch.randn(7, 7, 3, 64, generator=g) / 147 ** 0.5).to(dev),
              (1 + 0.1 * torch.randn(64, generator=g)).to(dev),
              (0.1 * torch.randn(64, generator=g)).to(dev)]
    params[1][::7] *= -1  # a negative BN scale: that channel pools -yc
    dy = torch.randn(n, px // 4, px // 4, 64, generator=g).to(
        dev, torch.bfloat16)
    return x, frames, params, dy


def _stem_grad_run(fn, params, dy):
    """(y, stats, grads wrt params) of a stem on data (no input grad)."""
    ps = [p.detach().clone().requires_grad_() for p in params]
    y, stats = fn(ps)
    return y, stats, torch.autograd.grad(y, ps, dy)


@pytest.mark.parametrize("entry,n,px", STEM_TRAIN_CASES)
def test_stem_train_kernel(dev, entry, n, px):
    from video_chapter_generation_tpu_torch.ops.stem_train import (
        stem_frames_train,
        stem_s2d_train,
        stem_train_bwd,
        stem_train_fwd,
        stem_train_reference,
    )

    g = torch.Generator().manual_seed(4)
    x, frames, params, dy = _stem_train_inputs(g, dev, entry, n, px)
    fn = stem_frames_train if entry == "frames" else stem_s2d_train
    f0, b0 = stem_train_fwd.launches, stem_train_bwd.launches
    y, st, gk = _stem_grad_run(lambda ps: fn(x, *ps), params, dy)
    torch.cuda.synchronize()
    assert (stem_train_fwd.launches, stem_train_bwd.launches) == (f0 + 1,
                                                                  b0 + 1)
    yr, str_, gr = _stem_grad_run(
        lambda ps: stem_train_reference(frames, *ps), params, dy)
    _close(y, yr)
    for a, b in zip(st, str_):
        _close(a, b)
    for a, b in zip(gk, gr):
        _grad_close(a, b)


def test_stem_train_runs_are_bitwise_equal(dev):
    """No float atomics: two runs of K11's forward and backward agree bit
    for bit."""
    from video_chapter_generation_tpu_torch.ops.stem_train import (
        stem_s2d_train,
    )

    g = torch.Generator().manual_seed(5)
    x, _, params, dy = _stem_train_inputs(g, dev, "u8", 16, 224)
    runs = [_stem_grad_run(lambda ps: stem_s2d_train(x, *ps), params, dy)
            for _ in range(2)]
    (y0, s0, g0), (y1, s1, g1) = runs
    assert torch.equal(y0, y1)
    assert all(torch.equal(a, b) for a, b in zip(s0, s1))
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_trunk_train_kernel(dev):
    from video_chapter_generation_tpu_torch.ops.tsm_block_train import (
        _block,
        block_train_bwd,
        block_train_fwd,
        finale_bwd,
        finale_fwd,
        trunk_link_bwd,
        trunk_link_fwd,
    )
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

    counters = (recompute_p, trunk_link_fwd, trunk_link_bwd, finale_fwd,
                finale_bwd, block_train_fwd, block_train_bwd)
    before = [fn.launches for fn in counters]
    kept_t, (y, st, gk) = kept_after_forward(
        lambda xs, ps: tsm_trunk_train(xs, regroup(ps), kinds, t))
    torch.cuda.synchronize()
    n = len(kinds)
    # p made again once per block; a link between each two blocks; the
    # finale and its backward prologue for the top block only
    assert [fn.launches - b for fn, b in zip(counters, before)] == [
        n, n - 1, n - 1, 1, 1, n, n]
    # the links compute what the finales compute: the forward agrees bit
    # for bit with the chain of per-block Functions, and keeps no p (each
    # block's p has the shape of its output); the backward moments sum in
    # another order, so the gradients agree in the bands, and two runs of
    # the trunk bit for bit
    kept_c, (yc, stc, gc) = kept_after_forward(chain)
    assert torch.equal(y, yc)
    assert all(torch.equal(a, b) for s, sc in zip(st, stc)
               for a, b in zip(s, sc))
    for a, b in zip(gk, gc):
        _grad_close(a, b)
    _, (y2, st2, gk2) = kept_after_forward(
        lambda xs, ps: tsm_trunk_train(xs, regroup(ps), kinds, t))
    assert torch.equal(y, y2)
    assert all(torch.equal(a, b) for a, b in zip(gk, gk2))
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


@pytest.mark.parametrize("kinds", [("proj", "plain"), ("plain", "plain"),
                                   ("plain", "s2"), ("s2", "plain")],
                         ids=lambda k: "->".join(k))
def test_trunk_link_kernels(dev, kinds):
    """Each link against its plain version: x, u and the moments of u
    forward; dq of the block below and its moments backward."""
    from video_chapter_generation_tpu_torch.ops.tsm_block_train import (
        BlockTrainState,
        trunk_link_bwd,
        trunk_link_bwd_reference,
        trunk_link_fwd,
        trunk_link_fwd_reference,
    )

    g = torch.Generator().manual_seed(7)
    t = 8
    c0, f0 = {"proj": (64, 64), "plain": (256, 64), "s2": (256, 128)}[
        kinds[0]]
    co0 = 4 * f0 if kinds[0] != "plain" else c0
    f1 = co0 // 4 if kinds[1] == "plain" else co0 // 2
    co1 = co0 if kinds[1] == "plain" else 4 * f1
    states = []
    for kind, c, f, co in ((kinds[0], c0, f0, co0), (kinds[1], co0, f1, co1)):
        states.append(BlockTrainState(
            _block_params(g, dev, c, f, co, kind != "plain"),
            2 if kind == "s2" else 1, t, 8, 1e-5))
    below, st = states
    x0 = torch.relu(torch.randn(2 * t, 16, 16, c0, generator=g)).to(
        dev, torch.bfloat16)
    below.forward(x0)
    x, u, mom = trunk_link_fwd(st, below)
    vb = below.vec
    fb, cb = below.f, below.co
    aff = [vb[4 * fb + i * cb:4 * fb + (i + 1) * cb] for i in range(4)]
    p_below, r_below = below.saved[2], below.residual()
    xr, ur, momr = trunk_link_fwd_reference(
        p_below, r_below, aff[0], aff[1], *(aff[2:] if below.proj else
                                            (None, None)),
        st.wf[0], t, 8)
    _close(x, xr)
    _close(u, ur)
    _close(mom[:2 * st.f], momr.flatten())
    st.forward(None, below)
    st.finale()
    dy = torch.randn(st.y.shape, generator=g).to(dev, torch.bfloat16)
    res, _ = st.backward(*st.finale_backward(dy), link=True)
    dq, mom3 = trunk_link_bwd(st, below, res)
    a, e, f = st.abc1.view(3, -1)
    du = (a * st.da1.float() + e * st.saved[0].float() + f).to(torch.bfloat16)
    sb = below.stats
    dqr, mom3r = trunk_link_bwd_reference(
        du, st.wf[0], res, st.x, p_below, below.saved[3],
        sb[4 * fb:4 * fb + cb], sb[4 * fb + 2 * cb:4 * fb + 3 * cb]
        if below.proj else None, t, 8)
    _close(dq, dqr)
    for k in range(3 if below.proj else 2):
        _grad_close(mom3[k * cb:(k + 1) * cb], mom3r[k])


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


@pytest.mark.parametrize("stride,proj,c,f", [(1, False, 256, 64),
                                            (2, True, 1024, 512)])
def test_k5_k12_runs_are_bitwise_equal(dev, stride, proj, c, f):
    """Two runs of K12's forward and backward, and of both K5 entries,
    agree bit for bit: every sum on the wgmma mainloop has a fixed order
    (K5's persistent grid hands tiles out by block index, not by arrival)."""
    from video_chapter_generation_tpu_torch.ops.tsm_block_train import _block
    from video_chapter_generation_tpu_torch.ops.tsm_conv import (
        tsm_conv1x1,
        tsm_conv1x1_bn_relu,
    )

    g = torch.Generator().manual_seed(9)
    t, hw, bf = 8, 14, torch.bfloat16
    co = 4 * f if proj else c
    x = torch.relu(torch.randn(2 * t, hw, hw, c, generator=g)).to(dev, bf)
    params = _block_params(g, dev, c, f, co, proj)
    ho = hw // stride
    dy = torch.randn(2 * t, ho, ho, co, generator=g).to(dev, bf)
    runs = [_grad_run(lambda xs, ps: _block(xs, ps, stride, t, 8, 1e-5), x,
                      params, dy) for _ in range(2)]
    (y0, s0, g0), (y1, s1, g1) = runs
    assert torch.equal(y0, y1)
    assert all(torch.equal(a, b) for a, b in zip(s0, s1))
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))

    w = (torch.randn(c, f, generator=g) / c ** 0.5).to(dev, bf)
    sc = torch.rand(f, generator=g).to(dev) + 0.5
    b = (0.1 * torch.randn(f, generator=g)).to(dev)
    for fn in (lambda: tsm_conv1x1_bn_relu(x, w, sc, b, t),
               lambda: tsm_conv1x1(x, w, t)):
        assert torch.equal(fn(), fn())


# --- serving kernels of the inference CLI: K8 (frames stem, BN + ReLU +
# pool) and K9 (W8A8 bottleneck). The pool and the int8 block compute the
# same float operations as their plain versions in the same order, so
# they must agree bit for bit; the stem's conv sums in another order.


@pytest.mark.parametrize("n,px", STEM_SHAPES)
def test_stem_frames_kernel(dev, n, px):
    from video_chapter_generation_tpu_torch.ops.stem import (
        bn_relu_maxpool,
        stem_frames,
        stem_frames_reference,
    )

    g = torch.Generator().manual_seed(7)
    x = torch.randn(n, px, px, 3, generator=g).to(dev, torch.bfloat16)
    w7 = (torch.randn(7, 7, 3, 64, generator=g) * 0.05).to(dev)
    s = torch.rand(64, generator=g).to(dev) + 0.5
    s[::5] *= -1
    b = (torch.randn(64, generator=g) * 0.1).to(dev)
    before = (stem_frames.launches, bn_relu_maxpool.launches)
    got = stem_frames(x, w7, s, b)
    torch.cuda.synchronize()
    assert (stem_frames.launches, bn_relu_maxpool.launches) == (
        before[0] + 1, before[1])
    assert got.shape == (n, px // 4, px // 4, 64)
    assert got.dtype == torch.bfloat16
    _close(got, stem_frames_reference(x, w7, s, b))


# (n, h, w): even sizes; odd ones (a last window of two rows or columns);
# a row wider than one column tile (W 130 at C 64: 65 outputs, two tiles
# of 33 and 32; C 8: one chunk a pixel, tiles of up to 128 outputs; C 24:
# three chunks, tiles of 42)
@pytest.mark.parametrize("n,h,w", [(4, 30, 22), (3, 31, 23), (2, 7, 130)])
@pytest.mark.parametrize("c", [64, 256, 8, 24])
def test_bn_relu_maxpool_kernel(dev, c, n, h, w):
    from video_chapter_generation_tpu_torch.ops.stem import (
        bn_relu_maxpool,
        bn_relu_maxpool_reference,
    )

    g = torch.Generator().manual_seed(8)
    x = torch.randn(n, h, w, c, generator=g).to(dev, torch.bfloat16)
    s = torch.randn(c, generator=g).to(dev)
    b = torch.randn(c, generator=g).to(dev)
    before = bn_relu_maxpool.launches
    got = bn_relu_maxpool(x, s, b)
    torch.cuda.synchronize()
    assert bn_relu_maxpool.launches == before + 1
    assert got.shape == (n, (h + 1) // 2, (w + 1) // 2, c)
    assert torch.equal(got, bn_relu_maxpool_reference(x, s, b))


def _int8_block(g, dev, c=512, f=128):
    mk = lambda *s: (torch.randn(*s, generator=g) * 0.05).to(dev)  # noqa: E731
    aff = lambda n: ((torch.randn(n, generator=g) * 0.1 + 1).to(dev),  # noqa: E731
                     (torch.randn(n, generator=g) * 0.1).to(dev))
    (s1, b1), (s2, b2), (s3, b3) = aff(f), aff(f), aff(c)
    scales = torch.tensor([0.05, 0.03, 0.02, 0.05])
    return (mk(c, f), mk(3, 3, f, f), mk(f, c), s1, b1, s2, b2, s3, b3,
            scales)


INT8_KINDS = [("i8", "i8"), ("i8", "bf16"), ("bf16", "i8"), ("bf16", "bf16")]


@pytest.mark.parametrize("c,f", [(512, 128), (1024, 256), (2048, 512)])
@pytest.mark.parametrize("x_kind,out_mode", INT8_KINDS)
def test_tsm_bottleneck_int8_kernel(dev, x_kind, out_mode, c, f):
    """The three layer widths (layer 2: fold 64 mixes two frame offsets
    in a 128-deep stage), both input kinds, both output kinds."""
    from video_chapter_generation_tpu_torch.ops.tsm_block_int8 import (
        int8_bottleneck_reference,
        tsm_bottleneck_int8,
    )

    g = torch.Generator().manual_seed(9)
    t = 4
    args = _int8_block(g, dev, c, f)
    if x_kind == "i8":
        x = torch.randint(-127, 128, (2 * t, 8, 6, c), generator=g,
                          dtype=torch.int8).to(dev)
    else:
        x = torch.randn(2 * t, 8, 6, c, generator=g).to(dev, torch.bfloat16)
    before = tsm_bottleneck_int8.launches
    got = tsm_bottleneck_int8(x, *args, t, out_mode=out_mode)
    torch.cuda.synchronize()
    assert tsm_bottleneck_int8.launches == before + 1
    ref_f, ref_q = int8_bottleneck_reference(x, *args, t)
    if out_mode == "i8":
        assert got.dtype == torch.int8
        assert torch.equal(got, ref_q), (got != ref_q).sum().item()
    else:
        assert torch.equal(got, ref_f.to(torch.bfloat16))
    again = tsm_bottleneck_int8(x, *args, t, out_mode=out_mode)
    assert torch.equal(got, again)


# --- K10: BigBird block-sparse attention of the middle query blocks ---


# (bs, hd, b, h, nb, r): the serving kernel's shape (bs 64, hd 64, P 8):
# one row, rows whose walks cross (b, h) boundaries (2 x 3 rows of 46
# query blocks over the card's blocks); the other shapes, where the ring
# and the mma.sync kernels are both held: every block size (16, 32, 48,
# 64), head dims of one panel (16, 32, 48, 64) and of two (80, 112, 128),
# 4 and 2 heads a ring tile (bs 16 at hd 16 with h 8; bs 16 and 32 at hd
# 32 with h 2) and one where h does not divide (h 3), P 5 to 10 (r 0, 1,
# 2, 3, 5), and tables of more than 512 entries
K10_CASES = [(16, 16, 2, 3, 12, 3), (16, 64, 2, 3, 12, 3),
             (64, 16, 2, 3, 12, 3), (64, 64, 2, 3, 12, 3),
             (64, 64, 2, 3, 48, 3), (64, 64, 1, 2, 9, 0),
             (64, 64, 3, 1, 20, 1), (32, 64, 2, 3, 24, 3),
             (48, 64, 2, 2, 16, 1), (48, 48, 2, 3, 12, 5),
             (64, 128, 2, 2, 16, 3), (32, 128, 1, 2, 20, 5),
             (16, 80, 2, 2, 24, 1), (48, 112, 1, 3, 12, 0),
             (32, 32, 2, 2, 16, 2), (64, 64, 2, 3, 12, 5),
             (16, 32, 2, 2, 130, 3), (16, 16, 2, 8, 20, 1)]


def _k10_inputs(bs, hd, b, h, nb, r, seed):
    import numpy as np

    from video_chapter_generation_tpu_torch.ops.sparse_attention import (
        structured_ids,
    )

    g = torch.Generator().manual_seed(seed)
    l = nb * bs
    bf = torch.bfloat16
    q, k, v = [torch.randn(b, l, h, hd, generator=g).to("cuda", bf)
               for _ in range(3)]
    mask = torch.ones(b, l, dtype=torch.int32)
    mask[-1, l - 3 * bs - 5:] = 0
    mask = mask.to("cuda")
    rand_map = (np.random.default_rng(bs + hd + nb).integers(
        0, nb, (nb, r)).astype(np.int32) if r else None)
    ids, valid = [torch.from_numpy(a).to("cuda")
                  for a in structured_ids(nb, rand_map)]
    return q, k, v, mask, ids, valid


@pytest.mark.parametrize("bs,hd,b,h,nb,r", K10_CASES)
def test_sparse_band_attention_kernel(dev, bs, hd, b, h, nb, r):
    """Padded keys (a whole block of them in the last row), random ids that
    may collide with the window (counted twice, as in the plain version);
    the kernel writes rows bs..L-bs of `out` and nothing else. A call
    counts in `launches` and in its route's counter: the serving kernel's
    at the serving shape only, where a table that is not structured_ids'
    raises before a launch. The ring and the mma.sync kernels, each forced,
    take this shape and any table (one whose band ids are moved too)."""
    from video_chapter_generation_tpu_torch.ops import sparse_attention as sa
    from video_chapter_generation_tpu_torch.ops.sparse_attention import (
        sparse_band_attention,
        sparse_band_attention_reference,
    )

    q, k, v, mask, ids, valid = _k10_inputs(bs, hd, b, h, nb, r, 10)
    route = sa.ROUTES[sa._route(bs, hd, ids.shape[1], nb - 2)]
    assert (route == "serving") == ((bs, hd, r) == (64, 64, 3))
    counts = lambda: {r_: getattr(sparse_band_attention,  # noqa: E731
                                  f"{r_}_launches") for r_ in sa.ROUTES}
    before, n0 = counts(), sparse_band_attention.launches
    out = torch.zeros_like(q)
    got = sparse_band_attention(q[:, bs:-bs], k, v, mask, ids, valid, bs,
                                out)
    torch.cuda.synchronize()
    assert sparse_band_attention.launches == n0 + 1
    assert counts() == {r_: before[r_] + (r_ == route) for r_ in sa.ROUTES}
    _close(got, sparse_band_attention_reference(q[:, bs:-bs], k, v, mask,
                                                ids, valid, bs))
    assert not out[:, :bs].any() and not out[:, -bs:].any()
    bad = ids.clone()
    bad[0, 1] = 1
    bad[-1, 3] = 0
    if route == "serving":
        with pytest.raises(ValueError, match="structured_ids"):
            sparse_band_attention(q[:, bs:-bs], k, v, mask, bad, valid, bs,
                                  torch.zeros_like(q))
        assert sparse_band_attention.launches == n0 + 1
    for forced in (1, 2):
        for tab in (ids, bad):
            before = counts()
            got = sa._launch(q[:, bs:-bs], k, v, mask, tab, valid, bs,
                             torch.zeros_like(q), forced)
            assert counts()[sa.ROUTES[forced]] == \
                before[sa.ROUTES[forced]] + 1
            _close(got, sparse_band_attention_reference(
                q[:, bs:-bs], k, v, mask, tab, valid, bs))
    with pytest.raises(ValueError, match="bf16"):
        sparse_band_attention(q[:, bs:-bs].float(), k, v, mask, ids, valid,
                              bs, out)


@pytest.mark.parametrize("bs,hd", [(64, 64), (32, 64), (16, 16), (48, 128)])
def test_sparse_band_attention_runs_are_bitwise_equal(dev, bs, hd):
    """Two runs bit for bit, on the shape's route and on the ring and the
    mma.sync kernels forced."""
    from video_chapter_generation_tpu_torch.ops import sparse_attention as sa
    from video_chapter_generation_tpu_torch.ops.sparse_attention import (
        sparse_band_attention,
    )

    q, k, v, mask, ids, valid = _k10_inputs(bs, hd, 2, 4, 24, 3, 11)
    outs = [torch.zeros_like(q) for _ in range(2)]
    for o in outs:
        sparse_band_attention(q[:, bs:-bs], k, v, mask, ids, valid, bs, o)
    assert torch.equal(outs[0], outs[1])
    for forced in (1, 2):
        outs = [sa._launch(q[:, bs:-bs], k, v, mask, ids, valid, bs,
                           torch.zeros_like(q), forced) for _ in range(2)]
        assert torch.equal(outs[0], outs[1])


# --- K5 (shift + 1x1 conv), K6 (frame normalize), K7 (temporal shift) ---


@pytest.mark.parametrize("c,f,t,hw", [(64, 64, 8, 14), (256, 128, 8, 14),
                                      (1024, 256, 4, 14), (2048, 512, 8, 7),
                                      (128, 128, 3, 5)])
def test_tsm_conv_kernel(dev, c, f, t, hw):
    """Inference (epilogue) and training (bare product) entries against
    the plain version in the output bands; the training backward (two
    matmuls and two K7 launches) against autograd through the plain
    version in the gradient bands. M = 2 t hw^2 rows is never a multiple
    of the 128-row tile (150 at 5x5)."""
    from video_chapter_generation_tpu_torch.ops.temporal_shift import (
        temporal_shift,
    )
    from video_chapter_generation_tpu_torch.ops.tsm_conv import (
        tsm_conv1x1,
        tsm_conv1x1_bn_relu,
        tsm_conv1x1_reference,
    )

    g = torch.Generator().manual_seed(7)
    bf = torch.bfloat16
    x = torch.randn(2 * t, hw, hw, c, generator=g).to(dev, bf)
    w = (torch.randn(c, f, generator=g) / c ** 0.5).to(dev, bf)
    s = torch.rand(f, generator=g).to(dev) + 0.5
    b = (0.1 * torch.randn(f, generator=g)).to(dev)
    before = tsm_conv1x1_bn_relu.launches
    got = tsm_conv1x1_bn_relu(x, w, s, b, t)
    torch.cuda.synchronize()
    assert tsm_conv1x1_bn_relu.launches == before + 1
    _close(got, tsm_conv1x1_reference(x, w, t, 8, s, b, relu=True))

    wf = w.float()
    shifts = temporal_shift.launches
    xk, wk = x.clone().requires_grad_(), wf.clone().requires_grad_()
    y = tsm_conv1x1(xk, wk, t)
    dy = torch.randn(y.shape, generator=g).to(dev, bf)
    y.backward(dy)
    xr, wr = x.clone().requires_grad_(), wf.clone().requires_grad_()
    yr = tsm_conv1x1_reference(xr, wr, t)
    yr.backward(dy)
    torch.cuda.synchronize()
    assert temporal_shift.launches == shifts + 2
    _close(y, yr)
    _grad_close(xk.grad, xr.grad)
    _grad_close(wk.grad, wr.grad)
    assert wk.grad.dtype == torch.float32


# (frames shape, offset of the input in its buffer): element counts that
# are not multiples of 48 (or 16), fewer than one group, and inputs that
# start 1-15 bytes past a 16-byte boundary
NORMALIZE_CASES = [((3, 5, 37, 41, 3), 0), ((1, 1, 1, 5, 3), 0),
                   ((2, 7, 13, 3), 5), ((16, 4, 9, 3), 7),
                   ((1, 31, 29, 3), 12), ((4, 16, 16, 3), 1)]


@pytest.mark.parametrize("shape,offset", NORMALIZE_CASES)
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_normalize_kernel_is_exact(dev, out_dtype, shape, offset):
    from video_chapter_generation_tpu_torch.ops.preprocess import (
        normalize_frames,
        normalize_frames_reference,
    )

    g = torch.Generator().manual_seed(8)
    n = 1
    for d in shape:
        n *= d
    buf = torch.randint(0, 256, (n + 16,), generator=g,
                        dtype=torch.uint8).to(dev)
    u8 = buf[offset:offset + n].view(shape)
    assert u8.data_ptr() % 16 == offset
    before = normalize_frames.launches
    got = normalize_frames(u8, out_dtype)
    torch.cuda.synchronize()
    assert normalize_frames.launches == before + 1
    assert torch.equal(got, normalize_frames_reference(u8, out_dtype))


@pytest.mark.parametrize("dtype,c", [(torch.bfloat16, 256),
                                     (torch.float32, 64),
                                     (torch.uint8, 24)])
def test_shift_kernel_is_exact(dev, dtype, c):
    from video_chapter_generation_tpu_torch.ops.temporal_shift import (
        temporal_shift,
        temporal_shift_reference,
    )

    g = torch.Generator().manual_seed(9)
    x = (torch.randn(2 * 8, 7, 7, c, generator=g) * 50).to(dtype).to(dev)
    for reverse in (False, True):
        got = temporal_shift(x, 8, 8, reverse)
        assert torch.equal(got, temporal_shift_reference(x, 8, 8, reverse))
    xk = x.float().requires_grad_()
    dy = torch.randn(x.shape, generator=g).to(dev)
    temporal_shift(xk, 8).backward(dy)
    assert torch.equal(xk.grad, temporal_shift_reference(dy, 8, 8, True))


# --- K14a: the W8A8 stride-2 block0; K14b: the int8 stem ---


@pytest.mark.parametrize("c,f", [(256, 128), (512, 256), (1024, 512)])
@pytest.mark.parametrize("x_kind,out_mode", INT8_KINDS)
def test_tsm_bottleneck_s2_int8_kernel(dev, x_kind, out_mode, c, f):
    """Bit for bit the plain version: the same float operations, the int8
    products exact; the three block0 widths."""
    from video_chapter_generation_tpu_torch.ops.tsm_block_int8 import (
        int8_s2_bottleneck_reference,
        tsm_bottleneck_s2_planar_int8,
    )

    g = torch.Generator().manual_seed(10)
    t = 4
    mk = lambda *s: (torch.randn(*s, generator=g) * 0.05).to(dev)  # noqa: E731
    aff = lambda n: ((torch.randn(n, generator=g) * 0.1 + 1).to(dev),  # noqa: E731
                     (torch.randn(n, generator=g) * 0.1).to(dev))
    (s1, b1), (s2, b2), (s3, b3), (sp, bp) = aff(f), aff(f), aff(4 * f), \
        aff(4 * f)
    args = (mk(c, f), mk(3, 3, f, f), mk(f, 4 * f), s1, b1, s2, b2, s3, b3,
            mk(c, 4 * f), sp, bp, torch.tensor([0.05, 0.03, 0.02, 0.05]))
    if x_kind == "i8":
        x = torch.randint(-127, 128, (2 * t, 14, 10, c), generator=g,
                          dtype=torch.int8).to(dev)
    else:
        x = torch.randn(2 * t, 14, 10, c, generator=g).to(dev, torch.bfloat16)
    before = tsm_bottleneck_s2_planar_int8.launches
    got = tsm_bottleneck_s2_planar_int8(x.view(2 * t, 14, 5, 2 * c), *args,
                                        t, out_mode=out_mode)
    torch.cuda.synchronize()
    assert tsm_bottleneck_s2_planar_int8.launches == before + 1
    assert got.shape == (2 * t, 7, 5, 4 * f)
    ref_f, ref_q = int8_s2_bottleneck_reference(x, *args, t)
    if out_mode == "i8":
        assert got.dtype == torch.int8
        assert torch.equal(got, ref_q), (got != ref_q).sum().item()
    else:
        assert torch.equal(got, ref_f.to(torch.bfloat16))


# (frames, px): 56 px; 36 px (a one-row last strip); 133 frames at 224
# px (28 strips a frame over 132 blocks: a second wave of one frame); a
# frame of 1 and of 2 cells a side (a cell of several validity classes);
# 260 and 320 px (column chunks)
INT8_STEM_SHAPES = [(4, 56), (3, 36), (133, 224), (2, 4), (3, 8), (8, 260),
                    (8, 320)]


@pytest.mark.parametrize("n,px", INT8_STEM_SHAPES)
def test_stem_s2d_int8_kernel(dev, n, px):
    """Bit for bit the plain version (the same float operations, the bias
    rows summed in the same order), one launch, no pool launch, two runs
    bit for bit."""
    from video_chapter_generation_tpu_torch.ops.stem import (
        bn_relu_maxpool,
        stem_int8_weights,
        stem_s2d_int8,
        stem_s2d_int8_plain,
        stem_s2d_reference,
    )

    g = torch.Generator().manual_seed(11)
    s4 = torch.randint(0, 256, (n, px // 4, px // 4, 48), generator=g,
                       dtype=torch.uint8).to(dev)
    w7 = (torch.randn(7, 7, 3, 64, generator=g) * 0.05).to(dev)
    s = torch.rand(64, generator=g).to(dev) + 0.5
    s[::5] *= -1  # a negative BN scale: its sv column is negative
    b = (torch.randn(64, generator=g) * 0.1).to(dev)
    before = (stem_s2d_int8.launches, bn_relu_maxpool.launches)
    got = stem_s2d_int8(s4, w7, s, b)
    torch.cuda.synchronize()
    assert (stem_s2d_int8.launches, bn_relu_maxpool.launches) == (
        before[0] + 1, before[1])
    want = stem_s2d_int8_plain(s4, *stem_int8_weights(w7, s, b))
    assert torch.equal(got, want), (got != want).sum().item()
    assert torch.equal(got, stem_s2d_int8(s4, w7, s, b))
    _close(got, stem_s2d_reference(s4, w7, s, b))  # the bf16 stem, near


# --- K15: a chain of plain bottlenecks in one launch ---


@pytest.mark.parametrize("nblk,c,f", [(2, 256, 64), (3, 512, 128),
                                      (1, 1024, 256)])
def test_tsm_bottleneck_chain_kernel(dev, nblk, c, f):
    """One launch, bit for bit the per-block K2/K3 launches, near the plain
    version; both entries."""
    from video_chapter_generation_tpu_torch.ops.tsm_block import (
        tsm_bottleneck_chain,
        tsm_bottleneck_chain_plain,
        tsm_bottleneck_halo_chain,
    )

    g = torch.Generator().manual_seed(12)
    t, bf = 8, torch.bfloat16
    x = torch.relu(torch.randn(2 * t, 12, 12, c, generator=g)).to(dev, bf)
    mk = lambda *s: (torch.randn(*s, generator=g) * 0.05).to(dev, bf)  # noqa: E731
    one = lambda n: torch.rand(n, generator=g).to(dev) + 0.5  # noqa: E731
    zero = lambda n: (torch.randn(n, generator=g) * 0.1).to(dev)  # noqa: E731
    blocks = [(mk(c, f), mk(3, 3, f, f), mk(f, c), one(f), zero(f), one(f),
               zero(f), one(c), zero(c)) for _ in range(nblk)]
    before = tsm_bottleneck_chain.launches
    got = tsm_bottleneck_chain(x, blocks, t)
    halo = tsm_bottleneck_halo_chain(x, blocks, t, planar_out=True)
    torch.cuda.synchronize()
    assert tsm_bottleneck_chain.launches == before + 2
    seq = x
    for blk in blocks:
        seq = tsm_bottleneck(seq, *blk, t)
    assert torch.equal(got, seq)
    assert torch.equal(halo, seq.view(2 * t, 12, 6, 2 * c))
    _close(got, tsm_bottleneck_chain_plain(x, blocks, t))


def test_sparse_band_attention_refuses_inputs_that_require_grad(dev):
    """K10 writes its output through a pointer, which autograd cannot see:
    on inputs that require a gradient the wrapper raises instead of
    dropping it; under no_grad the same inputs launch."""
    from video_chapter_generation_tpu_torch.ops.sparse_attention import (
        sparse_band_attention,
        structured_ids,
    )

    b, nb, h, hd, bs = 1, 10, 2, 64, 64
    l = nb * bs
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(b, l, h, hd, generator=g).to(dev, torch.bfloat16)
               for _ in range(3))
    mask = torch.ones(b, l, dtype=torch.int32, device=dev)
    ids, valid = (torch.from_numpy(a).to(dev)
                  for a in structured_ids(nb, None))
    out = torch.zeros_like(q)
    k.requires_grad_(True)
    before = sparse_band_attention.launches
    with pytest.raises(NotImplementedError, match="no backward"):
        sparse_band_attention(q[:, bs:-bs], k, v, mask, ids, valid, bs, out)
    assert sparse_band_attention.launches == before
    with torch.no_grad():
        sparse_band_attention(q[:, bs:-bs], k, v, mask, ids, valid, bs, out)
    assert sparse_band_attention.launches == before + 1


_NCCL_SEGMENT = r"""
import json, sys
import torch
from video_chapter_generation_tpu_torch.cli import train_segment
from video_chapter_generation_tpu_torch.ops.stem_train import stem_train_fwd
from video_chapter_generation_tpu_torch.ops.tsm_block_train import (
    block_train_bwd, block_train_fwd, trunk_link_bwd, trunk_link_fwd)
from video_chapter_generation_tpu_torch.parallel import dist

counters = (stem_train_fwd, block_train_fwd, block_train_bwd, trunk_link_fwd,
            trunk_link_bwd)
trainer = train_segment.main(sys.argv[1:])
print("RESULT " + json.dumps({"backend": dist.backend(),
                              "device": str(trainer.device),
                              "launches": [f.launches for f in counters]}))
"""


def test_segment_step_on_two_cards_over_nccl(dev, tmp_path):
    """train_segment (the tiny two-stream model on the kernels, 64-px s2d
    frames, 2 updates of 2 micro-steps) as two processes, one a card, over
    NCCL, against one process on the same global batches: each process
    on its own card, the same launches, and the BN running averages and
    AdamW moments at cosine >= 0.999 of one process's (bf16 rounds the
    two runs' products at other places)."""
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from video_chapter_generation_tpu_torch.core.checkpoint import (
        CheckpointManager,
    )
    from video_chapter_generation_tpu_torch.data.synth import (
        make_synth_corpus_on_disk,
    )

    root = Path(__file__).resolve().parents[1]
    paths = make_synth_corpus_on_disk(str(tmp_path / "corpus"), n_videos=9,
                                      video_sec=40, hw=64, seed=1,
                                      splits={"train": 8, "val": 1})

    def argv(name):
        return [f"data.{k}={paths[k]}" for k in (
            "img_dir", "data_file", "subtitle_dir", "train_vid_file",
            "val_vid_file")] + [
            "model.kind=two_stream", "model.stem_input=s2d",
            "data.batch_size=4", "data.clip_frame_num=16",
            "optim.gradient_accumulation_steps=2", "train.max_epochs=1",
            f"train.ckpt_dir={tmp_path / name}",
            f"train.log_dir={tmp_path / (name + '_logs')}",
            "train.resume=false", "--tiny"]

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(root))
    runs = {}
    for name, world in (("one", 1), ("two", 2)):
        envs = [env] if world == 1 else [dict(
            env, RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
            LOCAL_WORLD_SIZE="2", MASTER_ADDR="localhost",
            MASTER_PORT=str(port)) for r in range(2)]
        procs = [subprocess.Popen(
            [sys.executable, "-c", _NCCL_SEGMENT, *argv(name)], env=e,
            cwd=tmp_path, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for e in envs]
        outs = [p.communicate(timeout=600)[0].decode() for p in procs]
        for p, out in zip(procs, outs):
            assert p.returncode == 0, out
        runs[name] = [json.loads(line[7:]) for out in outs
                      for line in out.splitlines()
                      if line.startswith("RESULT ")]
    assert [r["backend"] for r in runs["two"]] == ["nccl", "nccl"]
    assert [r["device"] for r in runs["two"]] == ["cuda:0", "cuda:1"]
    assert all(r["launches"] == runs["one"][0]["launches"]
               for r in runs["two"])
    a = CheckpointManager(str(tmp_path / "two")).restore_latest()[1]
    b = CheckpointManager(str(tmp_path / "one")).restore_latest()[1]
    for k in [k for k in b["model"] if "running" in k]:
        _close(a["model"][k], b["model"][k])
    ea = torch.cat([s["exp_avg"].flatten()
                    for _, s in sorted(a["optimizer"]["state"].items())])
    eb = torch.cat([s["exp_avg"].flatten()
                    for _, s in sorted(b["optimizer"]["state"].items())])
    cos = torch.nn.functional.cosine_similarity(ea.double(), eb.double(),
                                                dim=0).item()
    assert cos >= 0.999, cos


def _tiny_trunk(dev, tsm_impl="auto", t=4):
    from video_chapter_generation_tpu_torch.models import convert
    from video_chapter_generation_tpu_torch.models.resnet import ResNet

    sizes = (1, 1, 1, 1)
    with torch.device("meta"):
        net = ResNet(50, n_segment=t, stage_sizes=sizes, dtype=torch.bfloat16,
                     tsm_impl=tsm_impl)
    tree = convert.random_jax_tree(net, convert.resnet_entries(sizes), seed=0)
    net.load_state_dict(convert.from_jax_resnet(tree, sizes), assign=True)
    return net.to(dev).eval()


def test_grad_cam_reentry_on_the_kernels(dev):
    """Grad-CAM at the last stage runs on the serving kernels (the capture
    forward launches them, the re-entry is the pool); at stage 3 the
    re-entered stride-2 block would need K4's backward, which it has not:
    its wrapper raises, naming "tap3" and "xla", and launches nothing;
    under "xla" the same re-entry differentiates."""
    from video_chapter_generation_tpu_torch.ops.tsm_block import (
        tsm_bottleneck_s2,
    )
    from video_chapter_generation_tpu_torch.visualization.interpret import (
        grad_cam_vision,
    )

    g = torch.Generator().manual_seed(0)
    frames = torch.randn(8, 64, 64, 3, generator=g).to(dev, torch.bfloat16)
    net = _tiny_trunk(dev)
    cam = grad_cam_vision(net, frames, stage=4)
    assert cam.shape == (8, 2, 2) and 0 <= cam.min() and cam.max() <= 1
    before = tsm_bottleneck_s2.launches
    capture = {}
    net(frames, capture=capture)
    act = capture["stage3"].detach().requires_grad_()
    launched = tsm_bottleneck_s2.launches
    with pytest.raises(NotImplementedError, match="'tap3' or 'xla'"):
        net(act, from_stage=3)
    assert tsm_bottleneck_s2.launches == launched == before + 3
    net.tsm_impl = "xla"
    cam3 = grad_cam_vision(net, frames, stage=3)
    assert torch.isfinite(cam3).all() and cam3.max() <= 1


def test_domain_specific_launch_counts(dev):
    """TwoStreamDomainSpecific (BERT tiny, the (1, 1, 1, 1) trunk, T 4,
    64-px frames, bf16): a serving call launches the frames stem once and
    each block's whole-block kernel once; a training step launches K11
    and the K13 trunk (K12 each block, the links, the finale, p made
    again) once each way."""
    from video_chapter_generation_tpu_torch.models.bert import (
        BertConfig,
        BertModel,
    )
    from video_chapter_generation_tpu_torch.models.fusion_variants import (
        TwoStreamDomainSpecific,
    )
    from video_chapter_generation_tpu_torch.ops.stem import stem_frames
    from video_chapter_generation_tpu_torch.ops.stem_train import (
        stem_train_bwd,
        stem_train_fwd,
    )
    from video_chapter_generation_tpu_torch.ops.tsm_block import (
        tsm_bottleneck,
        tsm_bottleneck_s2,
    )
    from video_chapter_generation_tpu_torch.ops.tsm_block_train import (
        block_train_bwd,
        block_train_fwd,
        finale_bwd,
        finale_fwd,
        trunk_link_bwd,
        trunk_link_fwd,
    )
    from video_chapter_generation_tpu_torch.ops.tsm_trunk_train import (
        recompute_p,
    )

    t, b, w = 4, 2, 3
    vision = _tiny_trunk(dev, t=t)
    model = TwoStreamDomainSpecific(BertModel(BertConfig.tiny()), vision,
                                    segment_size=t, hidden_size=32,
                                    dtype=torch.bfloat16).to(dev)
    g = torch.Generator().manual_seed(1)
    img = torch.randn(b, w, t, 64, 64, 3, generator=g).to(dev, torch.bfloat16)
    ids = torch.randint(1, 128, (b, w, 12), generator=g).to(dev)
    mask = torch.ones_like(ids)
    counted = (stem_frames, tsm_bottleneck, tsm_bottleneck_s2,
               stem_train_fwd, stem_train_bwd, block_train_fwd,
               block_train_bwd, finale_fwd, finale_bwd, trunk_link_fwd,
               trunk_link_bwd, recompute_p)

    def launches(fn):
        for f in counted:
            f.launches = 0
        fn()
        torch.cuda.synchronize()
        return [f.launches for f in counted]

    model.to_serving(dev)
    _, probs = model(img, ids, mask)
    assert torch.isfinite(probs).all()
    assert launches(lambda: model(img, ids, mask)) == \
        [1, 1, 3] + [0] * 9
    model.float().train()

    def step():
        logits, _ = model(img, ids, mask, train=True)
        logits.float().sum().backward()

    assert launches(step) == [0, 0, 0, 1, 1, 4, 4, 1, 1, 3, 3, 4]
