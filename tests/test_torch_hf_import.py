"""The port's HuggingFace weight imports (models/convert_hf.py) against
HF's own models and the JAX package's converters, on the CPU in float32:
a tiny transformers `ResNetModel` into the port ResNet, and a tiny
`BigBirdPegasusForConditionalGeneration` into the port Seq2Seq (random
weights, no network). Both state dicts load strictly. Also pins that
chip_smoke.py's renames of the port's state dicts into HF's keys, which
its hf_import phase imports back on the card at full width, give exactly
the keys and shapes of the transformers models."""

import importlib.util
import os
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_chapter_generation_tpu.models.resnet import ResNet as JaxResNet
from video_chapter_generation_tpu.models.resnet import (
    convert_hf_resnet as jax_convert_hf_resnet,
)
from video_chapter_generation_tpu.models.seq2seq import Seq2Seq as JaxSeq2Seq
from video_chapter_generation_tpu.models.seq2seq import (
    Seq2SeqConfig as JaxSeq2SeqConfig,
)
from video_chapter_generation_tpu.models.seq2seq import (
    convert_hf_seq2seq as jax_convert_hf_seq2seq,
)
from video_chapter_generation_tpu_torch.models.convert_hf import (
    convert_hf_resnet,
    convert_hf_seq2seq,
)
from video_chapter_generation_tpu_torch.models.resnet import ResNet
from video_chapter_generation_tpu_torch.models.seq2seq import (
    Seq2Seq,
    Seq2SeqConfig,
)

TOL = 1e-4
STAGES = (1, 1, 1, 1)
# the tiny BigBird of tests/test_sparse_attention.py:103-111 (one head, so
# HF's per-head random-block plan is one map a layer), and its inputs:
# 12 blocks of 16 tokens, so the block-sparse route engages
BIGBIRD = dict(vocab_size=128, max_positions=256,
               encoder_attention="block_sparse", block_size=16,
               num_rand_blocks=1, num_heads=1, activation="gelu_new",
               learned_positions=True, decoder_start_token_id=2,
               attention_bias=False)
SEQ_LEN, BLOCK = 192, 16


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def transformers():
    """transformers, imported here rather than at collection. Where this
    process has not imported it yet, it is imported without TensorFlow
    (USE_TF=0 while it loads; the environment is put back): these tests
    use its torch models, and TensorFlow's import is ~6 s of the ~8 that
    the first model class costs."""
    if "transformers" in sys.modules:
        return pytest.importorskip("transformers")
    old = os.environ.get("USE_TF")
    os.environ["USE_TF"] = "0"
    try:
        return pytest.importorskip("transformers")
    finally:
        if old is None:
            del os.environ["USE_TF"]
        else:
            os.environ["USE_TF"] = old


@pytest.fixture(scope="module")
def hf_resnet(transformers):
    cfg = transformers.ResNetConfig(
        embedding_size=64, hidden_sizes=[256, 512, 1024, 2048],
        depths=list(STAGES), layer_type="bottleneck",
        downsample_in_first_stage=False, downsample_in_bottleneck=False)
    torch.manual_seed(0)
    model = transformers.ResNetModel(cfg).eval()
    # HF initialises BN statistics to 0 and 1: move them, so the import's
    # running_mean / running_var mapping is tested too
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(0.1 * torch.randn(
                    m.num_features, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(
                    m.num_features, generator=gen))
    return model


@pytest.fixture(scope="module")
def hf_bigbird(transformers):
    cfg = transformers.BigBirdPegasusConfig(
        vocab_size=128, d_model=32, encoder_layers=2, decoder_layers=2,
        encoder_attention_heads=1, decoder_attention_heads=1,
        encoder_ffn_dim=64, decoder_ffn_dim=64, max_position_embeddings=256,
        attention_type="block_sparse", block_size=BLOCK,
        num_random_blocks=1, dropout=0.0, activation_dropout=0.0,
        attention_dropout=0.0, attention_probs_dropout_prob=0.0)
    torch.manual_seed(0)
    return transformers.BigBirdPegasusForConditionalGeneration(cfg).eval()


def _hf_rand_maps(hf_model):
    """Each encoder layer's random-block plan as HF's forward draws it
    (the plan of tests/test_sparse_attention.py:139-161), as [nb, 1]
    absolute-block maps for encode(rand_maps=...)."""
    nb = SEQ_LEN // BLOCK
    maps = []
    for layer in hf_model.model.encoder.layers:
        attn = layer.self_attn.self
        np.random.seed(attn.seed)
        plan_len, plan_blocks = attn._get_rand_attn_plan(SEQ_LEN, BLOCK, 1)
        rand_attn = attn._bigbird_block_rand_mask_with_head(
            from_seq_length=SEQ_LEN, to_seq_length=SEQ_LEN,
            from_block_size=BLOCK, to_block_size=BLOCK, num_heads=1,
            plan_from_length=plan_len, plan_num_rand_blocks=plan_blocks)
        full = np.zeros((nb, 1), np.int32)
        full[1:-1] = np.stack(rand_attn, axis=0)[0]
        maps.append(full)
    return maps


def test_hf_resnet_import_matches_hf_and_jax(hf_resnet):
    sd = convert_hf_resnet(hf_resnet.state_dict())
    port = ResNet(50, n_segment=0, stage_sizes=STAGES).eval()
    port.load_state_dict(sd, strict=True)
    for key, v in sd.items():  # the values themselves, not a rounding
        if key.endswith("num_batches_tracked"):
            continue
        assert v.dtype == torch.float32, key
    x = np.random.default_rng(0).standard_normal(
        (2, 64, 64, 3)).astype(np.float32)
    ours = port(torch.from_numpy(x)).numpy()
    with torch.no_grad():
        theirs = hf_resnet(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    pooled = theirs.pooler_output.flatten(1).numpy()
    jax_out = np.asarray(JaxResNet(stage_sizes=STAGES).apply(
        jax_convert_hf_resnet(hf_resnet.state_dict()), jnp.asarray(x),
        train=False))
    np.testing.assert_allclose(ours, pooled, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ours, jax_out, rtol=TOL, atol=TOL)


def test_hf_resnet_import_counters():
    """num_batches_tracked: copied where the HF dict has it, else 0."""
    hf = _chip_smoke().resnet_to_hf(
        ResNet(50, n_segment=0, stage_sizes=STAGES).state_dict())
    hf["embedder.embedder.normalization.num_batches_tracked"] = \
        torch.tensor(7)
    counters = [k for k in hf if k.endswith("num_batches_tracked")]
    for k in counters[1:]:
        del hf[k]
    sd = convert_hf_resnet(hf)
    ResNet(50, n_segment=0, stage_sizes=STAGES).load_state_dict(sd)
    assert int(sd["bn1.num_batches_tracked"]) == 7
    assert int(sd["layer4.0.downsample.1.num_batches_tracked"]) == 0


def test_hf_bigbird_import_matches_hf_and_jax(hf_bigbird):
    cfg = Seq2SeqConfig.tiny(**BIGBIRD)
    sd = convert_hf_seq2seq(hf_bigbird.state_dict(), cfg)
    port = Seq2Seq(cfg).eval()
    port.load_state_dict(sd, strict=True)

    rng = np.random.default_rng(1)
    ids = rng.integers(3, 128, size=(2, SEQ_LEN)).astype(np.int64)
    mask = np.ones((2, SEQ_LEN), np.int64)
    mask[1, 150:] = 0
    dec = rng.integers(3, 128, size=(2, 6)).astype(np.int64)
    dec[:, 0] = cfg.decoder_start_token_id
    maps = _hf_rand_maps(hf_bigbird)
    with torch.no_grad():
        enc = port.encode(torch.from_numpy(ids), torch.from_numpy(mask),
                          rand_maps=maps)
        ours = port.decode(torch.from_numpy(dec), enc,
                           torch.from_numpy(mask)).numpy()
        theirs = hf_bigbird(
            input_ids=torch.from_numpy(ids),
            attention_mask=torch.from_numpy(mask),
            decoder_input_ids=torch.from_numpy(dec)).logits.numpy()
    jcfg = JaxSeq2SeqConfig.tiny(**BIGBIRD)
    jm = JaxSeq2Seq(jcfg)
    variables = jax_convert_hf_seq2seq(hf_bigbird.state_dict(), jcfg)
    jenc = jm.apply(variables, jnp.asarray(ids, jnp.int32),
                    jnp.asarray(mask, jnp.int32), method=jm.encode,
                    rand_maps=maps)
    jax_out = np.asarray(jm.apply(variables, jnp.asarray(dec, jnp.int32),
                                  jenc, jnp.asarray(mask, jnp.int32),
                                  method=jm.decode))
    np.testing.assert_allclose(ours, theirs, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ours, jax_out, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", ["pegasus", "bart"])
def test_hf_seq2seq_import_passes_pegasus_and_bart_through(arch):
    """Pegasus and BART dicts keep their keys and values (the port's
    names are theirs); a dict without final_logits_bias gets zeros."""
    cfg = (Seq2SeqConfig.tiny() if arch == "pegasus" else
           Seq2SeqConfig.tiny(activation="gelu", pre_norm=False,
                              learned_positions=True, position_offset=2,
                              scale_embedding=False, embed_layernorm=True))
    torch.manual_seed(0)
    src = Seq2Seq(cfg).state_dict()
    src["lm_head.weight"] = src["model.shared.weight"]
    sd = convert_hf_seq2seq(src, cfg)
    Seq2Seq(cfg).load_state_dict(sd, strict=True)
    assert all(torch.equal(sd[k], src[k]) for k in sd)
    del src["final_logits_bias"]
    assert not convert_hf_seq2seq(src, cfg)["final_logits_bias"].any()


def test_chip_smoke_renames_give_hf_keys(hf_resnet, hf_bigbird):
    """chip_smoke.py's port -> HF renames give the transformers models'
    keys and shapes, and the imports give the port's dicts back equal."""
    smoke = _chip_smoke()
    port_rn = ResNet(50, n_segment=0, stage_sizes=STAGES).state_dict()
    hf_rn = smoke.resnet_to_hf(port_rn)
    want = {k: tuple(v.shape) for k, v in hf_resnet.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in hf_rn.items()} == want
    back = convert_hf_resnet(hf_rn)
    assert back.keys() == port_rn.keys()
    assert all(torch.equal(back[k], port_rn[k]) for k in back)

    cfg = Seq2SeqConfig.tiny(**BIGBIRD)
    port_bb = Seq2Seq(cfg).state_dict()
    hf_bb = smoke.bigbird_to_hf(port_bb)
    want = {k: tuple(v.shape) for k, v in hf_bigbird.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in hf_bb.items()} == want
    back = convert_hf_seq2seq(hf_bb, cfg)
    assert back.keys() == port_bb.keys()
    assert all(torch.equal(back[k], port_bb[k]) for k in back)
