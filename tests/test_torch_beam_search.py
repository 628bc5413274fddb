"""The port's beam search, top-k filter and sampling against the JAX
package on the CPU, in float32.

One tiny Pegasus per seed (3 seeds) in the JAX layout goes through the
JAX `beam_search` (jitted once per case, the weights passed as
arguments) and, carried over by models/convert.py, through the port's.
The decoder's projections are scaled up and EOS's final_logits_bias
raised, so that random weights neither echo their last token nor never
end: beams finish at different steps and the three early_stopping modes
give different results (checked), which exercises the finished pool and
its gates. Ids are equal; scores agree to 1e-5 relative (the logits
differ by float32 summation order).
"""

import itertools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_models import _perturb
from video_chapter_generation_tpu.models.seq2seq import (
    Seq2Seq as JaxSeq2Seq,
    Seq2SeqConfig as JaxSeq2SeqConfig,
    beam_search as jax_beam_search,
    generate as jax_generate,
    top_k_filter as jax_top_k_filter,
)
from video_chapter_generation_tpu_torch.models import convert
from video_chapter_generation_tpu_torch.models.seq2seq import (
    Seq2Seq,
    Seq2SeqConfig,
    beam_search,
    generate,
    top_k_filter,
)

VOCAB, B, L_IN, MAX_LEN, SEEDS = 96, 3, 24, 10, (0, 1, 2)
DEC_SCALE, EOS_BIAS = 5.0, 3.0
SCORE_TOL = dict(rtol=1e-5, atol=0)
EARLY = [True, False, "never"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module: its tiny models run thousands
    of small ops, which a full thread pool only slows, and by 10-70x when
    other test processes share the cores (the pool's threads contend)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(seed):
    """(port model, JAX variables, ids, mask): a tiny Pegasus whose
    decoder projections are scaled by DEC_SCALE, with random norm affines
    and a final_logits_bias of 0.5 N(0, 1) plus EOS_BIAS at EOS."""
    cfg = Seq2SeqConfig.tiny(vocab_size=VOCAB)
    rng = np.random.default_rng(seed)
    net = Seq2Seq(cfg).eval()
    p = _perturb(convert.random_jax_tree(
        net, convert.seq2seq_entries(cfg), seed=seed), rng)
    for i in range(cfg.decoder_layers):
        for part in ("self_attn", "encoder_attn", "ffn"):
            for leaf in p[f"dec_layer{i}"][part].values():
                if "kernel" in leaf:
                    leaf["kernel"] = leaf["kernel"] * DEC_SCALE
    p["final_logits_bias"] = 0.5 * rng.standard_normal(VOCAB).astype(
        np.float32)
    p["final_logits_bias"][cfg.eos_token_id] += EOS_BIAS
    net.load_state_dict(convert.from_jax_seq2seq(p, cfg))
    ids = rng.integers(3, VOCAB, (B, L_IN)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 15:] = 0
    return net, {"params": p}, ids, mask


@pytest.fixture(scope="module")
def cases():
    return [_case(seed) for seed in SEEDS]


def _port_beam(net, ids, mask, **kw):
    out_ids, scores = beam_search(net, torch.from_numpy(ids).long(),
                                  torch.from_numpy(mask), max_len=MAX_LEN,
                                  **kw)
    return out_ids.numpy(), scores.numpy()


@pytest.mark.parametrize("early_stopping", EARLY)
@pytest.mark.parametrize("length_penalty", [0.6, 1.0, 2.0])
@pytest.mark.parametrize("num_beams", [2, 4])
def test_beam_search_matches_jax(cases, num_beams, length_penalty,
                                 early_stopping):
    jm = JaxSeq2Seq(JaxSeq2SeqConfig.tiny(vocab_size=VOCAB))
    ref = jax.jit(lambda v, i, k: jax_beam_search(
        jm, v, i, k, num_beams=num_beams, max_len=MAX_LEN,
        length_penalty=length_penalty, early_stopping=early_stopping))
    for net, v, ids, mask in cases:
        want_ids, want_scores = ref(v, jnp.asarray(ids), jnp.asarray(mask))
        got_ids, got_scores = _port_beam(
            net, ids, mask, num_beams=num_beams,
            length_penalty=length_penalty, early_stopping=early_stopping)
        np.testing.assert_array_equal(got_ids, np.asarray(want_ids))
        assert got_scores.dtype == np.float32
        np.testing.assert_allclose(got_scores, np.asarray(want_scores),
                                   **SCORE_TOL)


def test_the_grid_exercises_the_finished_pool(cases):
    """The cases are not degenerate: beams end with EOS inside max_len,
    others run to its end, and the early_stopping modes disagree."""
    ended, ran_out, modes_differ = 0, 0, 0
    for (net, _, ids, mask), n, lp in itertools.product(
            cases, (2, 4), (0.6, 1.0, 2.0)):
        outs = [_port_beam(net, ids, mask, num_beams=n, length_penalty=lp,
                           early_stopping=es)[0] for es in EARLY]
        ended += int((outs[1] == 1).any(axis=1).sum())
        ran_out += int((outs[1] != 1).all(axis=1).sum())
        modes_differ += sum(not np.array_equal(outs[0], o) for o in outs[1:])
    assert ended >= 10 and ran_out >= 5 and modes_differ >= 5, (
        ended, ran_out, modes_differ)


def test_one_beam_is_greedy(cases):
    jm = JaxSeq2Seq(JaxSeq2SeqConfig.tiny(vocab_size=VOCAB))
    ref = jax.jit(lambda v, i, k: jax_generate(
        jm, v, i, k, max_len=MAX_LEN, return_logits=False)[0])
    for net, v, ids, mask in cases:
        greedy = generate(net, torch.from_numpy(ids).long(),
                          torch.from_numpy(mask), max_len=MAX_LEN).numpy()
        np.testing.assert_array_equal(
            greedy, np.asarray(ref(v, jnp.asarray(ids), jnp.asarray(mask))))
        np.testing.assert_array_equal(
            _port_beam(net, ids, mask, num_beams=1)[0], greedy)


def test_top_k_filter_matches_jax():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((4, 50)).astype(np.float32)
    logits[1, :5] = logits[1].max()  # a tie across the k-th value
    for k in (1, 3, 7):
        np.testing.assert_array_equal(
            top_k_filter(torch.from_numpy(logits), k).numpy(),
            np.asarray(jax_top_k_filter(jnp.asarray(logits), k)))


def test_temperature_and_top_k_greedy_matches_jax(cases):
    net, v, ids, mask = cases[1]
    jm = JaxSeq2Seq(JaxSeq2SeqConfig.tiny(vocab_size=VOCAB))
    want, _ = jax_generate(jm, v, jnp.asarray(ids), jnp.asarray(mask),
                           max_len=MAX_LEN, temperature=0.7, top_k=5,
                           return_logits=False)
    got = generate(net, torch.from_numpy(ids).long(), torch.from_numpy(mask),
                   max_len=MAX_LEN, temperature=0.7, top_k=5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _sample(net, ids, mask, seed, **kw):
    return generate(net, torch.from_numpy(ids).long(),
                    torch.from_numpy(mask), max_len=MAX_LEN, sample=True,
                    generator=torch.Generator().manual_seed(seed), **kw)


def test_sampling_top_1_is_greedy(cases):
    for net, _, ids, mask in cases:
        greedy = generate(net, torch.from_numpy(ids).long(),
                          torch.from_numpy(mask), max_len=MAX_LEN)
        assert torch.equal(_sample(net, ids, mask, 5, top_k=1), greedy)


def test_sampling_is_seeded(cases):
    net, _, ids, mask = cases[0]
    a = _sample(net, ids, mask, 11, temperature=1.5)
    assert torch.equal(a, _sample(net, ids, mask, 11, temperature=1.5))
    draws = {tuple(_sample(net, ids, mask, s, temperature=1.5).flatten()
                   .tolist()) for s in range(4)}
    assert len(draws) > 1  # the generator, not the model, decides


@pytest.mark.parametrize("k", [2, 4])
def test_sampled_tokens_stay_in_the_top_k(cases, k):
    """Teacher-forcing each sampled row back through decode_step: every
    token before the row's first EOS (that one included) is among the
    top k of its step's logits."""
    eos = 1
    for seed, (net, _, ids, mask) in enumerate(cases):
        out = _sample(net, ids, mask, seed, temperature=2.0, top_k=k)
        t_ids, t_mask = torch.from_numpy(ids).long(), torch.from_numpy(mask)
        cache = net.init_cache(B, MAX_LEN, net.encode(t_ids, t_mask))
        token = torch.zeros((B, 1), dtype=torch.long)
        done = torch.zeros(B, dtype=torch.bool)
        for pos in range(MAX_LEN):
            logits, cache = net.decode_step(token, pos, cache, t_mask,
                                            MAX_LEN)
            kth = torch.topk(logits, k).values[:, -1]
            picked = logits.gather(1, out[:, pos:pos + 1])[:, 0]
            assert ((picked >= kth) | done).all(), pos
            done = done | (out[:, pos] == eos)
            token = out[:, pos:pos + 1]
