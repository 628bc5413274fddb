"""The port's int8 serving paths against the JAX package, on the CPU.

- The two quantize_weight functions: equal to the JAX ones, exactly.
- The W8A8 bottleneck (K9's plain version, which the kernel wrapper runs
  on a CPU tensor) against the JAX integer spec int8_bottleneck_reference
  and the Pallas kernel in interpret mode, for int8 and float inputs and
  outputs: int8 outputs bit for bit; float outputs at 2e-5 absolute (the
  Pallas kernel multiplies by reciprocal scales where the spec divides).
- Calibration of a tiny ResNet (stage sizes (1, 2, 2, 2), T = 2, 32-px
  normalized frames, float32) against the JAX calibration: scales at
  1e-5 relative. The quantized trunk fed the JAX scales against the JAX
  quantized trunk (models/resnet.py FORCE_WHOLE_BLOCKS, as
  tests/test_int8_quant.py runs it): per frame cosine >= 0.9999 and
  pooled features within 0.05 absolute. That band is the quantization's
  own sensitivity, which the test shows: the two packages' float32
  trunks agree at 1e-4, while scaling the port's input by 1 + 1e-7 moves
  its own quantized features by more than 1e-3 (at 32 px layer 4 is one
  pixel a frame, so one requantization flip of one quantum reaches every
  output channel). Against the float trunk, cosine > 0.98, as the JAX
  test asserts; unit scales give another answer.
- Weight-only int8 Pegasus with the int8 cross-attention cache (tiny,
  float32): the port's quantize_seq2seq equals the JAX tree carried over,
  and greedy ids equal the JAX package's.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import video_chapter_generation_tpu.models.resnet as jax_resnet
from test_torch_models import _perturb
from video_chapter_generation_tpu.models.quant_layers import (
    quantize_weight as jax_quantize_weight_dense,
)
from video_chapter_generation_tpu.models.seq2seq import (
    Seq2Seq as JaxSeq2Seq,
    Seq2SeqConfig as JaxSeq2SeqConfig,
    generate as jax_generate,
)
from video_chapter_generation_tpu.ops.quantize import (
    calibrate_resnet_quant as jax_calibrate,
    quantize_seq2seq as jax_quantize_seq2seq,
)
from video_chapter_generation_tpu.ops.tsm_block_int8_pallas import (
    int8_bottleneck_reference as jax_int8_reference,
    quantize_weight as jax_quantize_weight,
    tsm_bottleneck_int8_pallas,
)
from video_chapter_generation_tpu_torch.models import convert
from video_chapter_generation_tpu_torch.models.quant_layers import (
    quantize_weight as quantize_weight_dense,
)
from video_chapter_generation_tpu_torch.models.resnet import ResNet
from video_chapter_generation_tpu_torch.models.seq2seq import (
    Seq2Seq,
    Seq2SeqConfig,
    generate,
)
from video_chapter_generation_tpu_torch.ops.quantize import (
    calibrate_resnet_quant,
    quantize_seq2seq,
)
from video_chapter_generation_tpu_torch.ops.tsm_block_int8 import (
    int8_bottleneck_reference,
    quantize_weight,
    tsm_bottleneck_int8,
)

SIZES, T = (1, 2, 2, 2), 2


@pytest.mark.parametrize("which", ["block", "dense"])
def test_quantize_weight_matches_jax(which):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((96, 40)).astype(np.float32)
    w[:, 3] = 0.0  # an all-zero channel: the scale clamp decides
    if which == "block":
        (q, s), (jq, js) = quantize_weight(torch.from_numpy(w)), \
            jax_quantize_weight(jnp.asarray(w))
        pairs = [(q, jq), (s, js)]
    else:
        pairs = []
        for axis in (0, 1):
            (q, s), (jq, js) = quantize_weight_dense(
                torch.from_numpy(w), axis), jax_quantize_weight_dense(w, axis)
            pairs += [(q, jq), (s, js)]
    for got, want in pairs:
        assert got.dtype == {jnp.int8: torch.int8,
                             jnp.float32: torch.float32}[want.dtype.type]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _block_inputs(seed=0, b=2, h=8, w=6, c=512, f=128):
    """The JAX package's own K9 test inputs (tests/test_int8_quant.py:24)."""
    rng = np.random.default_rng(seed)
    mk = lambda *s: (rng.normal(size=s) * 0.05).astype(np.float32)  # noqa: E731
    aff = lambda n: ((rng.normal(size=(n,)) * 0.1 + 1.0).astype(np.float32),  # noqa: E731
                     (rng.normal(size=(n,)) * 0.1).astype(np.float32))
    w1, w2, w3 = mk(c, f), mk(3, 3, f, f), mk(f, c)
    (s1, b1), (s2, b2), (s3, b3) = aff(f), aff(f), aff(c)
    scales = np.asarray([0.05, 0.03, 0.02, 0.05], np.float32)
    return (b * 4, h, w, c), (w1, w2, w3, s1, b1, s2, b2, s3, b3, scales)


@pytest.mark.parametrize("x_kind", ["i8", "f32"])
@pytest.mark.parametrize("out_mode", ["i8", "f32"])
def test_int8_bottleneck_matches_jax(x_kind, out_mode):
    shape, args = _block_inputs()
    rng = np.random.default_rng(2)
    x = (rng.integers(-127, 128, shape).astype(np.int8) if x_kind == "i8"
         else rng.normal(size=shape).astype(np.float32))
    jx, jargs = jnp.asarray(x), [jnp.asarray(a) for a in args]
    ref_f, ref_q = jax_int8_reference(jx, *jargs, 4)
    kernel = tsm_bottleneck_int8_pallas(
        jx, *jargs, 4, out_mode="i8" if out_mode == "i8" else "bf16",
        out_dtype=jnp.float32)
    targs = [torch.from_numpy(a) for a in args]
    got = tsm_bottleneck_int8(torch.from_numpy(x), *targs, 4,
                              out_mode="i8" if out_mode == "i8" else "bf16",
                              out_dtype=torch.float32)
    plain_f, plain_q = int8_bottleneck_reference(torch.from_numpy(x), *targs,
                                                 4)
    if out_mode == "i8":
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref_q))
        np.testing.assert_array_equal(got.numpy(), np.asarray(kernel))
        assert torch.equal(got, plain_q)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref_f), atol=2e-5,
                                   rtol=0)
        np.testing.assert_allclose(got.numpy(), np.asarray(kernel),
                                   atol=2e-5, rtol=0)
        assert torch.equal(got, plain_f)


def _cos(a, b):
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1))


@pytest.fixture(scope="module")
def calib_case():
    """A tiny frames-stem ResNet in both packages, its JAX calibration and
    quantized features (JAX whole-block kernels in interpret mode)."""
    rng = np.random.default_rng(3)
    frames = rng.normal(size=(2 * T, 32, 32, 3)).astype(np.float32)
    net = ResNet(50, n_segment=T, stem_input="frames", stage_sizes=SIZES)
    v = _perturb(convert.random_jax_tree(net, convert.resnet_entries(SIZES),
                                         seed=3), rng)
    net.load_state_dict(convert.from_jax_resnet(v, SIZES))
    net.eval()
    old = jax_resnet.FORCE_WHOLE_BLOCKS
    jax_resnet.FORCE_WHOLE_BLOCKS = True
    try:
        jm = jax_resnet.ResNet(stage_sizes=SIZES, n_segment=T,
                               tsm_impl="fusedall", dtype=jnp.float32)
        jscales = jax_calibrate(jm, v, jnp.asarray(frames))
        jq = np.asarray(jm.clone(quantize=True).apply(
            {**v, "quant": jscales}, jnp.asarray(frames)))
    finally:
        jax_resnet.FORCE_WHOLE_BLOCKS = old
    return net, torch.from_numpy(frames), jscales, jq, v


def test_calibration_matches_jax(calib_case):
    net, frames, jscales, _, _ = calib_case
    got = calibrate_resnet_quant(net, frames)
    want = convert.act_scales_from_jax(jscales)
    assert set(got) == set(want) == set(net.block_names())
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   rtol=1e-5, err_msg=name)


def test_quantized_features_match_jax(calib_case):
    net, frames, jscales, jq, _ = calib_case
    qnet = net.quantized(convert.act_scales_from_jax(jscales))
    got = qnet(frames)
    np.testing.assert_allclose(got.numpy(), jq, atol=0.05, rtol=0)
    assert _cos(got.numpy(), jq).min() >= 0.9999
    # the band's reason: a last-bit change of the input moves them too
    nudged = qnet(frames * (1 + 1e-7)).numpy()
    assert np.abs(nudged - got.numpy()).max() > 1e-3
    # it is the quantized path: close to the float trunk, not equal to it
    ref = net(frames).numpy()
    jm = jax_resnet.ResNet(stage_sizes=SIZES, n_segment=T,
                           dtype=jnp.float32)
    np.testing.assert_allclose(ref, np.asarray(jm.apply(
        calib_case[4], jnp.asarray(frames.numpy()))), atol=1e-4, rtol=0)
    assert _cos(got.numpy(), ref).min() > 0.98
    assert not np.allclose(got.numpy(), ref)
    # uncalibrated unit scales saturate and give another answer
    assert not np.allclose(net.quantized({})(frames).numpy(), got.numpy())


@pytest.fixture(scope="module")
def s2s_int8_case():
    rng = np.random.default_rng(4)
    cfg = Seq2SeqConfig.tiny()
    net = Seq2Seq(cfg).eval()
    p = _perturb(convert.random_jax_tree(net, convert.seq2seq_entries(cfg),
                                         seed=4), rng)
    net.load_state_dict(convert.from_jax_seq2seq(p, cfg))
    ids = rng.integers(2, cfg.vocab_size, (2, 16)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[0, 11:] = 0
    return cfg, p, net, ids, mask


def test_int8_seq2seq_generate_matches_jax(s2s_int8_case):
    cfg, p, net, ids, mask = s2s_int8_case
    qcfg = dataclasses.replace(cfg, weight_quant=True, kv_quant=True)
    jv = jax_quantize_seq2seq({"params": p})
    jm = JaxSeq2Seq(dataclasses.replace(JaxSeq2SeqConfig.tiny(),
                                        weight_quant=True, kv_quant=True))
    want, _ = jax.jit(lambda v_, i, k: jax_generate(
        jm, v_, i, k, max_len=10, return_logits=False))(
            jv, jnp.asarray(ids), jnp.asarray(mask))

    sd = quantize_seq2seq(net.state_dict())
    carried = convert.from_jax_seq2seq(jv["params"], qcfg)
    assert sd.keys() == carried.keys()
    for k in sd:
        assert sd[k].dtype == carried[k].dtype and torch.equal(
            sd[k], carried[k]), k
    qnet = Seq2Seq(qcfg).eval()
    qnet.load_state_dict(sd)
    got = generate(qnet, torch.from_numpy(ids).long(), torch.from_numpy(mask),
                   max_len=10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # int8 weights change the logits: a float model's first step differs
    enc = net.encode(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    qenc = qnet.encode(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    assert not torch.allclose(enc, qenc)
