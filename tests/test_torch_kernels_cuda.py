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
