"""model.tsm_impl and fuse_tsm in the port's ResNet against the JAX
package's ResNet with the same value, on the CPU.

Eval, float32: a tiny ResNet (stage sizes (1, 2, 1, 1), T = 4, 32-px
frames) under every value and fuse_tsm=False. The JAX side runs with
FORCE_WHOLE_BLOCKS and fold_bn_inference=True, so that it takes its
Pallas stem, whole-block kernels (K2-K4) and K5 in interpret mode where
the TPU would; the port takes the plain versions of its kernels. Held at
1e-4 absolute and relative (the trunk tolerance of test_torch_models.py:
dozens of convolutions summed in different orders).

Train, float64: one step of the per-block path (K5's training entry;
K7 before a plain conv1) against jax.grad, every parameter gradient at
1e-7 of its largest magnitude and every BN statistic at 1e-10 relative
(float64 makes both sides deterministic to rounding; test_torch_train.py
reasons the same way). The port's "pallas" is held to the JAX "tap3":
the same function, and off the TPU the JAX "pallas" runs
temporal_shift_conv1x1, whose products take preferred_element_type
float32 even under x64 (ops/temporal_shift.py:172-178).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import video_chapter_generation_tpu.models.resnet as jax_resnet
from video_chapter_generation_tpu_torch.core.config import Config
from video_chapter_generation_tpu_torch.models import convert
from video_chapter_generation_tpu_torch.models.resnet import (
    TSM_IMPLS,
    ResNet,
    Resnet50TSM,
)
from video_chapter_generation_tpu_torch.train.tasks import SegmentTask

T, B, HW = 4, 2, 32
SIZES = (1, 2, 1, 1)
TOL = dict(rtol=1e-4, atol=1e-4)


def _tree(seed):
    """A seeded ResNet tree in the JAX layout, BN affines and statistics
    perturbed so that folding and batch statistics show."""
    with torch.device("meta"):
        net = ResNet(50, n_segment=T, stage_sizes=SIZES)
    tree = convert.random_jax_tree(net, convert.resnet_entries(SIZES),
                                   seed=seed)
    rng = np.random.default_rng(seed)

    def walk(node):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v)
            elif k in ("scale", "bias", "mean", "var"):
                noise = rng.standard_normal(v.shape).astype(np.float32)
                node[k] = (np.abs(1 + 0.2 * noise) if k in ("scale", "var")
                           else 0.1 * noise)
    walk(tree)
    return tree


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B * T, HW, HW, 3)).astype(np.float32)
    return _tree(1), x


def _port(tree, dtype=torch.float32, **kw):
    net = ResNet(50, n_segment=T, stage_sizes=SIZES, dtype=dtype, **kw)
    net.load_state_dict(convert.from_jax_resnet(tree, SIZES))
    return net.to(dtype)


@pytest.mark.parametrize("impl,fuse", [(i, True) for i in TSM_IMPLS] + [
    (("pallas", "fusedblk", "tap3", "xla"), True), ("auto", False)],
    ids=list(TSM_IMPLS) + ["per_stage", "unfused"])
def test_eval_matches_jax(case, impl, fuse, monkeypatch):
    tree, x = case
    monkeypatch.setattr(jax_resnet, "FORCE_WHOLE_BLOCKS", True)
    m = jax_resnet.ResNet(stage_sizes=SIZES, n_segment=T, tsm_impl=impl,
                          fuse_tsm=fuse, fold_bn_inference=True)
    want = np.asarray(jax.jit(lambda v, a: m.apply(v, a, train=False))(
        tree, jnp.asarray(x)))
    got = _port(tree, tsm_impl=impl, fuse_tsm=fuse).eval()(
        torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_eval_routes():
    """Which blocks take which route, per value (the launch counts that
    chip_smoke.py pins on the card follow from these)."""
    net = ResNet(50, n_segment=16)
    blocks = list(zip(net._block_stages(), net.blocks()))

    def routes(impl, fuse=True):
        net.tsm_impl, net.fuse_tsm = impl, fuse
        return [net.eval_route(s, b) for s, b in blocks]

    for impl in ("auto", "fusedtrain", "fusedall"):
        assert routes(impl) == ["block"] * 16
    assert routes("pallas") == ["k5"] * 16
    fb = routes("fusedblk")
    assert fb.count("block") == 12 and fb.count("k5") == 4
    assert [r for r, (_, b) in zip(fb, blocks)
            if b.downsample is not None] == ["k5"] * 4
    assert routes("tap3") == ["tap3"] * 16
    assert routes("auto", False) == ["unfused"] * 16


def _as_port(tree):
    """A {params, batch_stats}-shaped JAX tree -> port state dict in
    float64 (the entry table without from_jax's float32 cast)."""
    out = {}
    for path, key, kind in convert.resnet_entries(SIZES):
        leaf = tree
        for p in path:
            leaf = leaf[p]
        out[key] = np.asarray(convert._to_torch_layout(
            np.asarray(leaf, np.float64), kind))
    return out


@pytest.mark.parametrize("impl,jax_impl,fuse", [
    ("pallas", "tap3", True), ("auto", "auto", False)], ids=["k5", "unfused"])
def test_training_step_matches_jax_float64(case, impl, jax_impl, fuse):
    tree, x = case
    g = np.random.default_rng(2).standard_normal((B * T, 2048))
    with jax.enable_x64(True):
        m = jax_resnet.ResNet(stage_sizes=SIZES, n_segment=T,
                              tsm_impl=jax_impl, fuse_tsm=fuse,
                              dtype=jnp.float64)
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     tree)

        def loss(params):
            y, mut = m.apply({"params": params,
                              "batch_stats": v64["batch_stats"]},
                             jnp.asarray(x, jnp.float64), train=True,
                             mutable=["batch_stats"])
            return (y * g).sum(), mut["batch_stats"]

        (_, stats), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            v64["params"])
        want = _as_port({"params": grads, "batch_stats": stats})
    net = _port(tree, torch.float64, tsm_impl=impl, fuse_tsm=fuse).train()
    y = net(torch.from_numpy(x).double())
    (y * torch.from_numpy(g)).sum().backward()
    for name, p in net.named_parameters():
        w = want[name]
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-7,
                                   atol=1e-7 * np.abs(w).max(), err_msg=name)
    for name, buf in net.state_dict().items():
        if "running" in name:
            np.testing.assert_allclose(buf.numpy(), want[name], rtol=1e-10,
                                       err_msg=name)


def test_per_stage_training_runs_every_route():
    """A per-stage tuple in training: the K11 stem for the "fusedtrain"
    stage, then the K12 block, K5, 3-tap and 3-product conv1s (plain
    versions here), with a gradient for every parameter."""
    net = _port(_tree(3), tsm_impl=("fusedtrain", "pallas", "tap3", "xla"))
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (B * T, HW, HW, 3)).astype(np.float32))
    before = {k: v.clone() for k, v in net.state_dict().items()
              if "running" in k}
    net.train()(x).square().mean().backward()
    assert all(p.grad is not None and p.grad.abs().sum() > 0
               for p in net.parameters())
    after = net.state_dict()
    assert all(not torch.equal(v, after[k]) for k, v in before.items())


@pytest.mark.parametrize("impl,fuse", [("auto", True), ("pallas", True),
                                       (("fusedtrain", "pallas", "tap3",
                                         "xla"), True), ("auto", False)],
                         ids=["auto", "pallas", "per_stage", "unfused"])
def test_remat_trains_every_route(impl, fuse):
    """remat=True (model.remat_vision) on each block's route: the same
    output, gradients and running statistics as remat=False, exactly
    (the same functions, computed again), float64."""
    tree = _tree(8)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (B * T, HW, HW, 3)))
    runs = []
    for remat in (True, False):
        net = _port(tree, torch.float64, tsm_impl=impl, fuse_tsm=fuse,
                    remat=remat).train()
        y = net(x)
        y.square().mean().backward()
        runs.append((y, [p.grad for p in net.parameters()],
                     [b for b in net.buffers()]))
    (y0, g0, b0), (y1, g1, b1) = runs
    assert torch.equal(y0, y1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert all(torch.equal(a, b) for a, b in zip(b0, b1))


def test_unknown_values_and_remat_are_refused():
    with pytest.raises(ValueError, match="one of"):
        ResNet(50, n_segment=T, tsm_impl="pallas2")
    with pytest.raises(ValueError, match="per-stage"):
        ResNet(50, n_segment=T, tsm_impl=("auto",) * 4)
    with pytest.raises(ValueError, match="per-stage"):
        Resnet50TSM(T, tsm_impl=("pallas",) * 3)
    net = ResNet(50, n_segment=T)
    with pytest.raises(ValueError, match="one of"):
        net.tsm_impl = "fused"
    # remat is no longer refused: it trains (test_remat_trains_every_route)
    assert ResNet(50, n_segment=T, remat=True).remat
    # the config knobs reach the trunk through the tasks
    cfg = Config().apply_overrides(["model.tsm_impl=fusedblk",
                                    "model.remat_vision=true"])
    vision = SegmentTask(cfg, tiny=True).model.vision_model
    assert vision.tsm_impl == "fusedblk" and vision.remat
    with pytest.raises(ValueError):
        SegmentTask(Config().apply_overrides(["model.tsm_impl=fast"]),
                    tiny=True)
