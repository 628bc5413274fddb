"""Training-mode ResNet-TSM trunk: every bottleneck under one autograd
Function, fused across blocks (kernel K13).

Counterpart of the JAX package's ops/tsm_trunk_train_pallas.py:118
`tsm_trunk_train(x, blocks, kinds, n_segment, n_div, eps)` with the same
block kinds and parameter tuples (:58-68):

    kinds: "proj" (stride-1 projection, layer 1's block 0), "s2"
    (stride-2 projection, block 0 of later stages), "plain" (the rest)
    plain params: (w1, w2, w3, g1, be1, g2, be2, g3, be3)
    proj / s2:    (w1, w2, w3, wp, g1, be1, g2, be2, g3, be3, gp, bep)

Returns (y, stats): the trunk output and one stats tuple per block.

On the card, `_TrunkTrain` runs the K12 entries of csrc/conv_train.cu
block after block, linked as the JAX trunk links them:

- forward: block N's conv1 is `trunk_link_fwd`, which computes block
  N-1's finale as it loads (bit for bit what `finale_fwd` gives) and
  writes block N's input x once; only the top block launches
  `finale_fwd`.
- backward: `finale_bwd` runs for the top block only; every other
  block's dq and BN3/BNp backward moments come from the epilogue of the
  block above's conv1 data gradient (`trunk_link_bwd`), which adds its
  residual gradient, applies the relu mask (x > 0) and sums the moments
  in per-tile rows reduced in a fixed order. The moments sum in another
  order than `finale_bwd`'s, so gradients may differ from the per-block
  chain's in the last bits; the forward does not.
- as the JAX trunk does (:96-101), the trunk keeps no block's p, the
  largest tensor of a block (4F channels): its forward drops each p once
  the link above (or the top finale) has read it, and its backward makes
  p again from the saved z (`recompute_p`, one launch of
  vcg_block_train_recompute_p, the forward's FK3 on the same operands, so
  bit for bit the forward's p): the top block's before its finale
  backward, block N-1's just before block N's backward link, which reads
  it, as does block N-1's own backward next. Per block it keeps x (its
  input), u, z and, in a projection block, pr. Where the JAX link
  recovers pr of a projection block by inverting the finale
  (tsm_block_train_pallas.py:769-780), the port reads the pr it keeps.

A CPU tensor chains the plain block versions under autograd.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from . import _build, _calls
from .tsm_block_train import (
    BlockTrainState,
    _workspace,
    trunk_link_bwd,
    tsm_block_train_reference,
)

STRIDES = {"plain": 1, "proj": 1, "s2": 2}


def unpack(params, kind: str):
    """A block's parameter tuple -> the 12-slot (w1 w2 w3 wp g1 be1 g2 be2
    g3 be3 gp bep) form, None where a plain block has no projection."""
    if kind == "plain":
        w1, w2, w3, g1, be1, g2, be2, g3, be3 = params
        return (w1, w2, w3, None, g1, be1, g2, be2, g3, be3, None, None)
    if len(params) != 12:
        raise ValueError(f"a {kind} block takes 12 parameters")
    return tuple(params)


def trunk_reference(x, blocks, kinds, n_segment: int, n_div: int = 8,
                    eps: float = 1e-5):
    """Plain version: the plain blocks chained under autograd."""
    stats = []
    for params, kind in zip(blocks, kinds):
        w1, w2, w3, wp, g1, be1, g2, be2, g3, be3, gp, bep = unpack(params,
                                                                   kind)
        x, st = tsm_block_train_reference(
            x, w1, w2, w3, g1, be1, g2, be2, g3, be3, n_segment, n_div, eps,
            wp, gp, bep, STRIDES[kind])
        stats.append(st)
    return x, tuple(stats)


def recompute_p(st: BlockTrainState) -> torch.Tensor:
    """One launch of vcg_block_train_recompute_p: the p = conv1x1(relu(
    bn2(z)), w3) of block st's forward, made again from its saved z."""
    fn = _build.load("conv_train").vcg_block_train_recompute_p
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    z = st.saved[1]
    nt, h, w, c = st.x.shape
    ho, wo = z.shape[1], z.shape[2]
    dev = z.device
    p = torch.empty(nt, ho, wo, st.co, dtype=torch.bfloat16, device=dev)
    mom = torch.empty(2 * st.co, dtype=torch.float32, device=dev)
    part = _workspace(dev, nt, h, w, c, st.f, st.co, st.stride)
    rc = _calls.on_device(fn, dev, z.data_ptr(), st.wf[2].data_ptr(),
                          st.vec.data_ptr(), p.data_ptr(), mom.data_ptr(),
                          part.data_ptr(), nt, ho, wo, st.f, st.co)
    _calls.count(recompute_p)
    if rc != 0:
        raise RuntimeError(f"recompute_p kernel failed: CUDA error {rc}")
    return p


recompute_p.launches = 0


def trunk_train_fwd(x, blocks, kinds, n_segment, n_div, eps):
    """The trunk's forward on the kernels -> (y, per-block states, none
    of them keeping its p)."""
    states, below = [], None
    for params, kind in zip(blocks, kinds):
        st = BlockTrainState(unpack(params, kind), STRIDES[kind], n_segment,
                             n_div, eps)
        st.forward(x, below)
        if below is not None:
            below.set_p(None)
        states.append(st)
        below, x = st, None
    y = below.finale()
    below.set_p(None)
    return y, states


def trunk_train_bwd(dy, states):
    """The trunk's backward on the kernels -> (dx, per-block grads in the
    12-slot order). Frees each block's saved tensors as it goes."""
    grads = [None] * len(states)
    top = states[-1]
    top.set_p(recompute_p(top))
    dq, mom3 = top.finale_backward(dy)
    for i in range(len(states) - 1, 0, -1):
        st, below = states[i], states[i - 1]
        res, grads[i] = st.backward(dq, mom3, link=True)
        st.set_p(None)
        below.set_p(recompute_p(below))
        dq, mom3 = trunk_link_bwd(st, below, res)
        states[i] = None
    dx, grads[0] = states[0].backward(dq, mom3)
    states[0] = None
    return dx, grads


class _TrunkTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kinds, n_segment, n_div, eps, *flat):
        blocks, i = [], 0
        for kind in kinds:
            k = 9 if kind == "plain" else 12
            blocks.append(flat[i:i + k])
            i += k
        y, states = trunk_train_fwd(x.contiguous(), blocks, kinds,
                                    n_segment, n_div, eps)
        ctx.states, ctx.kinds = states, kinds
        ctx.dtypes = [t.dtype for t in flat]
        stats = [s for st in states for s in st.stats_tuple()]
        ctx.mark_non_differentiable(*stats)
        return (y, *stats)

    @staticmethod
    def backward(ctx, dy, *_dstats):
        dx, grads = trunk_train_bwd(dy, ctx.states)
        ctx.states = None
        flat = []
        for g, kind in zip(grads, ctx.kinds):
            w1, w2, w3, wp, g1, be1, g2, be2, g3, be3, gp, bep = g
            flat += ([w1, w2, w3, g1, be1, g2, be2, g3, be3] if kind == "plain"
                     else list(g))
        flat = [g.to(dt) for g, dt in zip(flat, ctx.dtypes)]
        return (dx, None, None, None, None, *flat)


def tsm_trunk_train(x: torch.Tensor, blocks: Sequence[Sequence[torch.Tensor]],
                    kinds: Sequence[str], n_segment: int, n_div: int = 8,
                    eps: float = 1e-5) -> Tuple[torch.Tensor, tuple]:
    """x [N*T, H, W, C] through every bottleneck -> (y [N*T, H', W', C'],
    per-block stats tuples), differentiable in x and every block
    parameter."""
    kinds = tuple(kinds)
    if len(blocks) != len(kinds):
        raise ValueError("one kind per block")
    if x.device.type == "cpu":
        return trunk_reference(x, blocks, kinds, n_segment, n_div, eps)
    if x.device.type != "cuda":
        raise NotImplementedError(f"tsm_trunk_train on {x.device}")
    flat = [t for params in blocks for t in params]
    y, *stats = _TrunkTrain.apply(x, kinds, n_segment, n_div, eps, *flat)
    out, i = [], 0
    for kind in kinds:
        k = 8 if kind != "plain" else 6
        out.append(tuple(stats[i:i + k]))
        i += k
    return y, tuple(out)
