"""The port's chain of plain bottlenecks (K15) and ResNet(chain_blocks=True)
against the JAX package, on the CPU.

- tsm_bottleneck_chain and tsm_bottleneck_halo_chain (their plain version
  on a CPU tensor) against the JAX flat and halo chains in interpret mode,
  2 and 3 blocks, planar_out on and off, float32: within 1e-5.
- The chain equals the port's plain per-block sequence exactly, through
  both entries.
- Model level, on the JAX package's own chain_blocks case
  (tests/test_tsm_block_pallas.py:393-420: stage sizes (1, 3, 2, 1),
  32 px, n_segment 4): the port's chain_blocks=True against the JAX
  chain_blocks=True trunk with its flat chain (float32, the model-level
  band of tests/test_torch_models.py) and bit for bit against the port's
  chain_blocks=False; the chain calls counted. The port's model has one
  chain route for both entries; the JAX package's own test holds its halo
  trunk to its unchained trunk within 1e-6.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import video_chapter_generation_tpu.models.resnet as jax_resnet
import video_chapter_generation_tpu_torch.ops.tsm_block as port_block
from test_torch_models import _perturb
from video_chapter_generation_tpu.ops import tsm_block_pallas as tbp
from video_chapter_generation_tpu_torch.models import convert
from video_chapter_generation_tpu_torch.models.resnet import STAGE_SIZES, ResNet
from video_chapter_generation_tpu_torch.ops.tsm_block import (
    tsm_bottleneck_chain,
    tsm_bottleneck_halo_chain,
    tsm_bottleneck_reference,
)

T, NB, HW, C, F_ = 4, 2, 8, 256, 64
TRUNK_TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_torch_models.py


def _blocks(nblk, seed=30):
    """nblk plain blocks' float32 weights and folded BN (numpy)."""
    rng = np.random.default_rng(seed)
    mk = lambda *s: (rng.normal(size=s) * 0.05).astype(np.float32)  # noqa: E731
    aff = lambda n: ((rng.normal(size=(n,)) * 0.1 + 1.0).astype(np.float32),  # noqa: E731
                     (rng.normal(size=(n,)) * 0.1).astype(np.float32))
    return [(mk(C, F_), mk(3, 3, F_, F_), mk(F_, C), *aff(F_), *aff(F_),
             *aff(C)) for _ in range(nblk)]


@pytest.mark.parametrize("form,nblk,planar_out", [
    ("flat", 2, False), ("flat", 3, True),
    ("halo", 2, True), ("halo", 3, False)])
def test_chain_matches_jax(form, nblk, planar_out):
    rng = np.random.default_rng(31)
    x = np.maximum(rng.normal(size=(NB * T, HW, HW, C)), 0).astype(np.float32)
    blocks = _blocks(nblk)
    jax_fn = (tbp.tsm_bottleneck_chain_pallas if form == "flat"
              else tbp.tsm_bottleneck_halo_chain_pallas)
    port_fn = (tsm_bottleneck_chain if form == "flat"
               else tsm_bottleneck_halo_chain)
    want = np.asarray(jax_fn(jnp.asarray(x), [tuple(map(jnp.asarray, b))
                                              for b in blocks], T,
                             planar_out=planar_out))
    tblocks = [tuple(map(torch.from_numpy, b)) for b in blocks]
    got = port_fn(torch.from_numpy(x), tblocks, T, planar_out=planar_out)
    shape = ((NB * T, HW, HW // 2, 2 * C) if planar_out
             else (NB * T, HW, HW, C))
    assert got.shape == want.shape == shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the port's plain per-block sequence, exactly
    v = torch.from_numpy(x)
    for b in tblocks:
        v = tsm_bottleneck_reference(v, *b, T)
    assert torch.equal(got.reshape(v.shape), v)


def test_resnet_chain_blocks_matches_jax(monkeypatch):
    """(1, 3, 2, 1) at 32 px, n_segment 4, the JAX package's own
    chain_blocks case (tests/test_tsm_block_pallas.py:393), seeded random
    weights in both packages, the JAX flat chain."""
    sizes = (1, 3, 2, 1)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((8, 32, 32, 3)).astype(np.float32)
    net = ResNet(50, n_segment=4, stem_input="frames", stage_sizes=sizes)
    v = _perturb(convert.random_jax_tree(net, convert.resnet_entries(sizes),
                                         seed=9), rng)
    net.load_state_dict(convert.from_jax_resnet(v, sizes))
    net.eval()
    monkeypatch.setattr(jax_resnet, "FORCE_WHOLE_BLOCKS", True)
    m = jax_resnet.ResNet(stage_sizes=sizes, n_segment=4,
                          tsm_impl="fusedall", chain_blocks=True)
    want = np.asarray(jax.jit(lambda v_, x_: m.apply(v_, x_, train=False))(
        v, jnp.asarray(x)))
    unchained = net(torch.from_numpy(x))
    calls = []
    plain = port_block.tsm_bottleneck_chain_plain
    monkeypatch.setattr(port_block, "tsm_bottleneck_chain_plain",
                        lambda x_, b, *a: calls.append(len(b)) or plain(
                            x_, b, *a))
    net.chain_blocks = True
    got = net(torch.from_numpy(x))
    assert calls == [2]  # layer2's blocks 1-2: the only stage of 3 blocks
    np.testing.assert_allclose(got.numpy(), want, **TRUNK_TOL)
    assert torch.equal(got, unchained)


def test_chain_plan():
    """Which stages chain: ResNet-50 chains blocks 1.. of all four stages
    (the JAX package leaves layer2 at 224 px unchained for VMEM); a
    quantized stage, capture or a non-whole-block route does not chain."""
    with torch.device("meta"):
        net = ResNet(50, n_segment=16, chain_blocks=True).eval()
    sizes = STAGE_SIZES[50]
    none = [None] * sum(sizes)
    assert net._chained(none, None) == [True] * 4
    assert net._chained(none, {}) == [False] * 4
    quant = none[:3] + [None] + ["i8"] * 3 + none[7:]
    assert net._chained(quant, None) == [True, False, True, True]
    net.tsm_impl = "fusedblk"  # block0s leave the whole-block route only
    assert net._chained(none, None) == [True] * 4
    net.tsm_impl = "tap3"
    assert net._chained(none, None) == [False] * 4
    net.tsm_impl = "auto"
    net.chain_blocks = False
    assert net._chained(none, None) == [False] * 4
