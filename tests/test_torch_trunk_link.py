"""The training trunk's cross-block links (kernel K13) against the JAX
package's trunk-mode pieces, on the CPU.

The port's plain versions of the two links (ops/tsm_block_train.py
`trunk_link_fwd_reference`, `trunk_link_bwd_reference`) are held to the
JAX package's tsm_block_train_pallas `_forward` / `_forward_s2` with
prev=... and trunk=True (conv1 computing the finale of the block below as
it loads) and `_backward` / `_backward_s2` with trunk=... (conv1's data
gradient epilogue applying that block's relu mask and summing its BN3/BNp
backward moments), run in interpret mode on the same numpy inputs from a
seed, for every link kind of the ResNet50 trunk: proj -> plain, plain ->
plain, plain -> s2 and s2 -> plain. Compared in float32 at the
tolerances of tests/test_torch_train_ops.py: the forward (block N's
input x, its u and the moments of u) at 1e-4, dq of the block below and
its moment sums at 2e-4 of their largest magnitude.

The JAX link makes p of the block below again from that block's z and
recovers its pr by inverting the finale; the port reads both (p made
again by recompute_p, pr kept), so here p is made from z as the JAX
epilogue makes it and pr is the one the finale read.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from video_chapter_generation_tpu.ops import tsm_block_train_pallas as tbt
from video_chapter_generation_tpu_torch.ops.temporal_shift import (
    temporal_shift_reference,
)
from video_chapter_generation_tpu_torch.ops.tsm_block_train import (
    conv_nhwc,
    finale_reference,
    trunk_link_bwd_reference,
    trunk_link_fwd_reference,
    tsm_block_train_reference,
)

T, NDIV, EPS = 4, 8, 1e-5
FWD_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_REL = 2e-4

LINKS = {
    # (kind below, kind of block N): (C, F of block N, F below, H = W)
    ("proj", "plain"): (32, 8, 8, 8),
    ("plain", "plain"): (32, 8, 8, 8),
    ("plain", "s2"): (32, 16, 8, 8),
    ("s2", "plain"): (64, 16, 16, 4),
}


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _affine(rng, n):
    return ((1.0 + 0.1 * rng.standard_normal(n)).astype(np.float32),
            (0.1 * rng.standard_normal(n)).astype(np.float32))


def _bn_vectors(rng, n):
    """(sa, sb, mu) of a batch-stat BN, as the JAX trunk derives them."""
    g, be = _affine(rng, n)
    mu = (0.2 * rng.standard_normal(n)).astype(np.float32)
    var = (0.5 + rng.random(n)).astype(np.float32)
    sa = (g / np.sqrt(var + EPS)).astype(np.float32)
    return sa, (be - mu * sa).astype(np.float32), mu


def _below(rng, kind, c, fp, h):
    """What the links read of the block below: its z, BN2 affine and w3
    (p = conv3(relu(bn2(z))), as the JAX epilogue makes it again), its
    residual r (x, or pr through BNp), BN3/BNp vectors and means."""
    z = rng.standard_normal((T, h, h, fp)).astype(np.float32)
    sa2, sb2, _ = _bn_vectors(rng, fp)
    w3 = (rng.standard_normal((fp, c)) / np.sqrt(fp)).astype(np.float32)
    p = np.maximum(z * sa2 + sb2, 0.0).reshape(-1, fp) @ w3
    sa3, sb3, mu3 = _bn_vectors(rng, c)
    b = dict(z=z, sa2=sa2, sb2=sb2, w3=w3, p=p.reshape(T, h, h, c),
             r=rng.standard_normal((T, h, h, c)).astype(np.float32),
             sa3=sa3, sb3=sb3, mu3=mu3, sap=None, sbp=None, mup=None)
    if kind != "plain":
        b["sap"], b["sbp"], b["mup"] = _bn_vectors(rng, c)
    return b


def _block(rng, kind, c, f):
    """Block N's (w1, w2, w3[, wp], g1, be1, g2, be2, g3, be3[, gp, bep])."""
    co = c if kind == "plain" else 2 * c
    mk = lambda *s: (rng.standard_normal(s) / np.sqrt(np.prod(s[:-1])))  # noqa: E731
    ws = [mk(c, f), mk(3, 3, f, f), mk(f, co)] + (
        [mk(c, co)] if kind != "plain" else [])
    aff = [*_affine(rng, f), *_affine(rng, f), *_affine(rng, co)]
    aff += [*_affine(rng, co)] if kind != "plain" else []
    return [a.astype(np.float32) for a in ws] + aff


def _jax_link(kind_below, kind, b, params, dy):
    """JAX trunk mode: block N's forward from the block below, then its
    backward into the block below. Returns (x, u, stats, dq_below,
    moments [2|3, C] with the BNp row divided by sap as the JAX trunk
    divides it)."""
    j = lambda a: jnp.asarray(a)  # noqa: E731
    h = b["p"].shape[1]
    c = b["p"].shape[-1]
    five = lambda a: j(a).reshape(1, T, *a.shape[1:])  # noqa: E731
    mode = "plain" if kind_below == "plain" else "proj"
    prev = (mode, five(b["p"]), five(b["r"]), j(b["sa3"]), j(b["sb3"]),
            None if b["sap"] is None else j(b["sap"]),
            None if b["sbp"] is None else j(b["sbp"]))
    if kind == "plain":
        w1, w2, w3, g1, be1, g2, be2, g3, be3 = map(j, params)
        wp = gp = bep = None
        x5, u5, z5, p5, pr5, stats = tbt._forward(
            None, w1, w2, w3, g1, be1, g2, be2, g3, be3, T, NDIV, EPS,
            prev=prev, trunk=True)
    else:
        w1, w2, w3, wp, g1, be1, g2, be2, g3, be3, gp, bep = map(j, params)
        x5, u5, z5, p5, pr5, stats = tbt._forward_s2(
            None, w1, w2, w3, wp, g1, be1, g2, be2, g3, be3, gp, bep, T,
            NDIV, EPS, prev=prev, trunk=True)
    # block N's own finale and its backward prologue, as the JAX trunk does
    sa3 = np.asarray(g3) / np.sqrt(np.asarray(stats[5]) + EPS)
    sb3 = np.asarray(be3) - np.asarray(stats[4]) * sa3
    a3 = np.asarray(p5) * sa3 + sb3
    if kind == "plain":
        y = np.maximum(a3 + np.asarray(x5), 0.0)
    else:
        sap = np.asarray(gp) / np.sqrt(np.asarray(stats[7]) + EPS)
        sbp = np.asarray(bep) - np.asarray(stats[6]) * sap
        y = np.maximum(a3 + np.asarray(pr5) * sap + sbp, 0.0)
    dq = np.where(y > 0, dy.reshape(y.shape), 0.0).astype(np.float32)
    s0 = dq.sum((0, 1, 2, 3))
    s1 = (dq * (np.asarray(p5) - np.asarray(stats[4]))).sum((0, 1, 2, 3))
    s1p = (None if kind == "plain" else
           j((dq * (np.asarray(pr5) - np.asarray(stats[6]))).sum(
               (0, 1, 2, 3))))
    spec = (mode, five(b["z"]), j(b["sa2"]), j(b["sb2"]), j(b["w3"]),
            j(b["mu3"]))
    if mode == "proj":
        cpp = b["sap"] * b["mup"] + b["sbp"]
        spec += (j(b["sa3"]), j(b["sb3"]), j(cpp))
    tr = dict(dq=j(dq), s0=j(s0), s1=j(s1), s1p=s1p, prev=spec)
    res = (x5, u5, z5, None, None, pr5, stats, w1, w2, w3, wp, g1, be1,
           g2, be2, g3, be3, gp, bep)
    bwd = tbt._backward if kind == "plain" else tbt._backward_s2
    _, (dout, mprev) = bwd(T, NDIV, EPS, res, None, trunk=tr)
    dout, mprev = np.asarray(dout), np.asarray(mprev)
    if kind == "s2":
        # the planar even/odd-column dq and per-plane sums, interleaved
        # and folded as tsm_trunk_train_pallas.py:196-204 does
        dout = dout.reshape(1, T, h, h // 2, 2, c).reshape(1, T, h, h, c)
        mprev = mprev[:, :c] + mprev[:, c:]
    elif mprev.shape[0] == 3:
        mprev = np.concatenate([mprev[:2], mprev[2:] / b["sap"]])
    x4 = np.asarray(x5).reshape(T, h, h, c)
    return (x4, np.asarray(u5).reshape(T, h, h, -1), stats,
            dout.reshape(T, h, h, c), mprev)


def _port_link(kind_below, kind, b, params, dy):
    """The port's plain links around block N's plain version, autograd
    giving the gradient of u (du) and of the residual path (res)."""
    t = {k: (None if v is None else _t(v)) for k, v in b.items()}
    w1 = _t(params[0])
    x, u, mom = trunk_link_fwd_reference(t["p"], t["r"], t["sa3"], t["sb3"],
                                         t["sap"], t["sbp"], w1, T, NDIV)
    xr = x.clone().requires_grad_()  # the residual (or projection) path
    x1 = x.clone().requires_grad_()  # conv1's path
    seen = {}

    def conv1(_x, w):
        seen["u"] = conv_nhwc(temporal_shift_reference(x1, T, NDIV), w)
        seen["u"].retain_grad()
        return seen["u"]

    ps = [_t(a) for a in params]
    if kind == "plain":
        w1_, w2, w3, g1, be1, g2, be2, g3, be3 = ps
        wp = gp = bep = None
    else:
        w1_, w2, w3, wp, g1, be1, g2, be2, g3, be3, gp, bep = ps
    y, _ = tsm_block_train_reference(
        xr, w1_, w2, w3, g1, be1, g2, be2, g3, be3, T, NDIV, EPS, wp, gp,
        bep, 1 if kind == "plain" else 2, conv1=conv1)
    (y * _t(dy)).sum().backward()
    torch.testing.assert_close(seen["u"].detach(), u)
    pr = None if kind_below == "plain" else t["r"]
    dq, mom3 = trunk_link_bwd_reference(
        seen["u"].grad, w1, xr.grad, x, t["p"], pr, t["mu3"],
        t["mup"], T, NDIV)
    return x, u, mom, dq, mom3


def _close_grad(got, want, name):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-3)
    np.testing.assert_allclose(got, want, rtol=GRAD_REL,
                               atol=GRAD_REL * scale, err_msg=name)


@pytest.mark.parametrize("link", list(LINKS), ids=lambda k: "->".join(k))
def test_link_matches_jax_trunk_mode(link):
    kind_below, kind = link
    c, f, fp, h = LINKS[link]
    rng = np.random.default_rng(41 + list(LINKS).index(link))
    b = _below(rng, kind_below, c, fp, h)
    params = _block(rng, kind, c, f)
    ho = h if kind == "plain" else h // 2
    co = c if kind == "plain" else 2 * c
    dy = rng.standard_normal((T, ho, ho, co)).astype(np.float32)

    jx, ju, jstats, jdq, jmom = _jax_link(kind_below, kind, b, params, dy)
    x, u, mom, dq, mom3 = _port_link(kind_below, kind, b, params, dy)

    np.testing.assert_allclose(x.numpy(), jx, **FWD_TOL, err_msg="x")
    np.testing.assert_allclose(u.numpy(), ju, **FWD_TOL, err_msg="u")
    m = T * h * h
    mu1 = mom[0] / m
    np.testing.assert_allclose(mu1.numpy(), np.asarray(jstats[0]), **FWD_TOL)
    np.testing.assert_allclose((mom[1] / m - mu1 * mu1).numpy(),
                               np.asarray(jstats[1]), **FWD_TOL)
    _close_grad(dq.numpy(), jdq, "dq of the block below")
    for k in range(jmom.shape[0]):
        _close_grad(mom3[k].numpy(), jmom[k], f"moment row {k}")
    if kind_below == "plain":
        assert torch.count_nonzero(mom3[2]) == 0


def test_link_fwd_is_the_finale_then_the_shifted_conv1():
    """x is finale_reference of the block below bit for bit, and the edge
    frames the shift drops get no conv1 contribution."""
    rng = np.random.default_rng(5)
    b = _below(rng, "proj", 32, 8, 4)
    t = {k: _t(v) for k, v in b.items() if v is not None}
    w1 = _t(rng.standard_normal((32, 8)))
    x, u, _ = trunk_link_fwd_reference(t["p"], t["r"], t["sa3"], t["sb3"],
                                       t["sap"], t["sbp"], w1, T, NDIV)
    assert torch.equal(x, finale_reference(t["p"], t["r"], t["sa3"],
                                           t["sb3"], t["sap"], t["sbp"]))
    fold = 32 // NDIV
    last = x[T - 1:T].clone()
    last[..., :fold] = 0  # frame T-1's first fold reads frame T: zero
    last[..., fold:2 * fold] = x[T - 2:T - 1, ..., fold:2 * fold]
    torch.testing.assert_close(u[T - 1:T], conv_nhwc(last, w1))
