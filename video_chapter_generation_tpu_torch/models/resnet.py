"""ResNet-50 with Temporal Shift Module (counterpart of the JAX package's
models/resnet.py).

Parameters and buffers carry torchvision's names and layouts
(`conv1.weight`, `layer1.0.downsample.1.running_var`, ...), so the JAX
package's `convert_torchvision_resnet50` reads this state dict as it is.
The stride sits on the 3x3 (v1.5); the projection is a 1x1 with the
block's stride on the unshifted input. Every block shifts ('blockres' TSM
on conv1's input). NHWC throughout.

- eval(): BatchNorm folds into a per-channel scale and bias (eps 1e-5) and
  every bottleneck runs as one call of the fused inference kernels in ops/
  (stem_s2d or stem_frames, tsm_bottleneck, tsm_bottleneck_s2). The W8A8
  twin (`ResNet.quantized`; the JAX package's quantize=True,
  models/resnet.py:785-857) runs blocks 1..n-1 of each stage of layers
  2-4 with at least two blocks on tsm_bottleneck_int8 instead: the first
  takes the stage's bf16 activation, the last emits bf16, the rest pass
  int8. Their activation scales are `act_scales` (ops/quantize.py
  calibrates them), held outside the state dict as the JAX package holds
  them outside its checkpoints, in its "quant" collection. With the
  module switch INT8_S2_BLOCKS (JAX :41-46, read at forward time) the
  block0 of a quantized stage runs the W8A8 stride-2 kernel
  (tsm_bottleneck_s2_planar_int8, K14a) where the stage before "links" to
  it, and that stage's last block then emits int8 when it is quantized
  too: see `_links` and `_quant_plan`.
- chain_blocks=True (JAX :572-579, 805-831): in eval, blocks 1..n-1 of a
  stage with n >= 3 blocks on the whole-block route, not quantized, run
  as one tsm_bottleneck_chain launch (K15). The JAX package leaves a
  stage unchained where its TPU kernels would not fit VMEM (224 px:
  layer2, `_chain_stage` :901-916); the port chains every such stage,
  the same function.
- train(): BatchNorm normalizes with batch statistics and the running
  averages move by the JAX package's convention (models/resnet.py:543-548,
  :892-898): mean = 0.9 mean + 0.1 mu and var = 0.9 var + 0.1 var_batch
  with the BIASED batch variance (torch's BatchNorm would use the unbiased
  one). The stem and the trunk train through the kernel entries
  stem_s2d_train (or stem_frames_train) and tsm_trunk_train at every batch
  size; on the CPU those take their plain versions. (The JAX package
  leaves its kernels for the plain path above a residual budget,
  models/resnet.py:603-744; the port does not: its plain autograd path
  keeps more on the card than the kernel trunk, so it is no way out of a
  memory limit.)

`tsm_impl` (one value, or one per stage) and `fuse_tsm` pick each block's
route as the JAX package's models/resnet.py:295-391, 751-756 do on the
TPU. In eval: "auto", "fusedtrain" and "fusedall" run every block on the
whole-block kernels (above); "fusedblk" runs the plain stride-1 blocks on
them and each stage's block 0 as K5 (ops/tsm_conv.py, folded BN1 + ReLU
in its epilogue) and then the rest of the block as plain torch ops;
"pallas" runs every block that way; "tap3" and "xla" make conv1 by the
plain 3-tap or 3-product form. In train, "auto" and "fusedtrain" (a
single value) take the kernel stem and trunk (above), and any other
value the per-block path: the plain stem (the K11 stem where a stage is
"fusedtrain"), then per block conv1 by K5's training entry ("fusedall",
"fusedblk", "pallas"), by the K12 whole-block kernel ("fusedtrain" in a
per-stage tuple) or by the 3-tap / 3-product form, and conv2, conv3, the
projection and batch-stat BN as plain torch ops. fuse_tsm=False shifts
with K7 (ops/temporal_shift.py) before a plain conv1, in both modes.
The parameters are the same under every value, so one checkpoint serves
all. An unknown value raises (the JAX package runs it as "xla").

remat=True (model.remat_vision; JAX :566-570, 747-749) trains every
block on the per-block route of its stage's tsm_impl, "auto" taking the
K12 whole-block kernel as "fusedtrain" does, and rematerializes each:
torch.utils.checkpoint (non-reentrant) keeps a block's input and drops
the rest after the forward, and the backward runs the block's forward
again before its own backward. The stem is the K11 one wherever the
trunk would be. The BN running averages move once a step, from the
first forward's statistics.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.preprocess import depth_to_space4, normalize_frames
from ..ops.stem import stem_frames, stem_s2d
from ..ops.stem_train import stem_frames_train, stem_s2d_train
from ..ops.temporal_shift import (
    temporal_shift,
    temporal_shift_conv1x1,
    temporal_shift_conv1x1_3tap,
)
from ..ops.tsm_block import (
    bottleneck_tail_reference,
    tsm_bottleneck,
    tsm_bottleneck_chain,
    tsm_bottleneck_s2,
)
from ..ops.tsm_block_int8 import (
    QuantBottleneck,
    int8_bottleneck,
    int8_s2_bottleneck,
    quantize_bottleneck,
    quantize_s2_bottleneck,
)
from ..ops.tsm_block_train import (
    _block,
    at_least_f32,
    bn_train,
    conv_nhwc,
    tsm_block_train_reference,
)
from ..ops.tsm_conv import tsm_conv1x1, tsm_conv1x1_bn_relu
from ..ops.tsm_trunk_train import tsm_trunk_train, unpack

STAGE_SIZES = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}
BN_EPS = 1e-5
BN_MOMENTUM = 0.9  # running = 0.9 running + 0.1 batch (flax convention)
# model.tsm_impl values (JAX models/resnet.py:106-154, 328-372, 559-565);
# "auto" names the whole trunk's per-mode mix, so a per-stage tuple takes
# the others only
TSM_IMPLS = ("auto", "fusedtrain", "fusedall", "fusedblk", "pallas", "tap3",
             "xla")
_K5_IMPLS = ("fusedall", "fusedblk", "pallas")

# W8A8 stride-2 block0s (K14a) and int8 stage tails under a quantized twin
# (JAX models/resnet.py:41-46; off there by default). Read at forward
# time, so a test or a script may set it.
INT8_S2_BLOCKS = False


def check_tsm_impl(tsm_impl, n_stages: int):
    """A tsm_impl value as ResNet keeps it: one name, or a tuple of one per
    stage; anything else raises ValueError naming the accepted values."""
    if isinstance(tsm_impl, str):
        if tsm_impl not in TSM_IMPLS:
            raise ValueError(f"tsm_impl {tsm_impl!r}: one of {TSM_IMPLS}, or "
                             f"one per stage of {TSM_IMPLS[1:]}")
        return tsm_impl
    impls = tuple(tsm_impl)
    if len(impls) != n_stages or any(i not in TSM_IMPLS[1:] for i in impls):
        raise ValueError(f"tsm_impl {tsm_impl!r}: one of {TSM_IMPLS}, or "
                         f"{n_stages} per-stage values of {TSM_IMPLS[1:]}")
    return impls


def fold_bn(bn: nn.BatchNorm2d):
    """Inference BatchNorm as (scale, bias), float32."""
    s = bn.weight.float() * torch.rsqrt(bn.running_var.float() + BN_EPS)
    return s, bn.bias.float() - bn.running_mean.float() * s


def _hwio_view(conv: nn.Conv2d) -> torch.Tensor:
    """OIHW conv weight as an HWIO view (1x1: [Cin, Cout]); autograd
    flows through it to the parameter."""
    w = conv.weight.permute(2, 3, 1, 0)
    if w.shape[0] == 1 and w.shape[1] == 1:
        w = w[0, 0]
    return w


def _hwio(conv: nn.Conv2d, dtype) -> torch.Tensor:
    """OIHW conv weight -> HWIO (1x1: [Cin, Cout]) in dtype, contiguous."""
    return _hwio_view(conv).to(dtype).contiguous()


@torch.no_grad()
def update_running(bn: nn.BatchNorm2d, mu: torch.Tensor,
                   var: torch.Tensor) -> None:
    """Running averages by the flax convention, with the biased batch
    variance the kernels return."""
    for buf, v in ((bn.running_mean, mu), (bn.running_var, var)):
        buf.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * v.to(buf.dtype))


class Bottleneck(nn.Module):
    """torchvision Bottleneck parameter layout (conv1..3, bn1..3,
    downsample.{0,1})."""

    def __init__(self, cin: int, features: int, stride: int,
                 projection: bool):
        super().__init__()
        f = features
        self.stride = stride
        self.conv1 = nn.Conv2d(cin, f, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(f, eps=BN_EPS)
        self.conv2 = nn.Conv2d(f, f, 3, stride=stride, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(f, eps=BN_EPS)
        self.conv3 = nn.Conv2d(f, 4 * f, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(4 * f, eps=BN_EPS)
        self.downsample = (
            nn.Sequential(nn.Conv2d(cin, 4 * f, 1, stride=stride, bias=False),
                          nn.BatchNorm2d(4 * f, eps=BN_EPS))
            if projection else None)

    def folded(self, dtype) -> dict:
        """Kernel-ready weights (JAX layout, dtype) and folded BN (f32)."""
        p = {"w1": _hwio(self.conv1, dtype), "w2": _hwio(self.conv2, dtype),
             "w3": _hwio(self.conv3, dtype)}
        p["s1"], p["b1"] = fold_bn(self.bn1)
        p["s2"], p["b2"] = fold_bn(self.bn2)
        p["s3"], p["b3"] = fold_bn(self.bn3)
        p["wp"] = p["sp"] = p["bp"] = None
        if self.downsample is not None:
            p["wp"] = _hwio(self.downsample[0], dtype)
            p["sp"], p["bp"] = fold_bn(self.downsample[1])
        return p

    def quantized(self, act_scales) -> QuantBottleneck:
        """The W8A8 form of this block (JAX models/resnet.py:435-468): the
        float32 folded weights (not cast first) quantized per output
        channel, with the block's (sx, sz, sy2, sout)."""
        s1, b1 = fold_bn(self.bn1)
        s2, b2 = fold_bn(self.bn2)
        s3, b3 = fold_bn(self.bn3)
        w = [_hwio(conv, torch.float32)
             for conv in (self.conv1, self.conv2, self.conv3)]
        return quantize_bottleneck(*w, s1, b1, s2, b2, s3, b3, act_scales)

    def quantized_s2(self, act_scales) -> QuantBottleneck:
        """The W8A8 form of a stride-2 projection block0 (JAX
        models/resnet.py:470-500): quantized as `quantized`, and the
        projection too."""
        s1, b1 = fold_bn(self.bn1)
        s2, b2 = fold_bn(self.bn2)
        s3, b3 = fold_bn(self.bn3)
        sp, bp = fold_bn(self.downsample[1])
        w = [_hwio(conv, torch.float32) for conv in
             (self.conv1, self.conv2, self.conv3, self.downsample[0])]
        return quantize_s2_bottleneck(*w[:3], s1, b1, s2, b2, s3, b3, w[3],
                                      sp, bp, act_scales)

    def chain_params(self, p: dict) -> tuple:
        """A plain block's folded weights as tsm_bottleneck_chain takes
        them (w1, w2, w3, s1, b1, s2, b2, s3, b3)."""
        return tuple(p[k] for k in ("w1", "w2", "w3", "s1", "b1", "s2", "b2",
                                    "s3", "b3"))

    def kind(self) -> str:
        """The training trunk's block kind (ops/tsm_trunk_train.py)."""
        if self.downsample is None:
            return "plain"
        return "s2" if self.stride == 2 else "proj"

    def train_params(self) -> tuple:
        """The block's parameters in the trunk's tuple layout: plain (w1,
        w2, w3, g1, be1, g2, be2, g3, be3); proj/s2 (w1, w2, w3, wp, g1,
        be1, g2, be2, g3, be3, gp, bep). Weights are HWIO views."""
        convs = [self.conv1, self.conv2, self.conv3]
        if self.downsample is not None:
            convs.append(self.downsample[0])
        return (tuple(_hwio_view(c) for c in convs)
                + tuple(t for bn in self.batch_norms()
                        for t in (bn.weight, bn.bias)))

    def batch_norms(self) -> List[nn.BatchNorm2d]:
        """In the order of the block's stats tuple (bn1, bn2, bn3, proj)."""
        bns = [self.bn1, self.bn2, self.bn3]
        if self.downsample is not None:
            bns.append(self.downsample[1])
        return bns

    def run(self, x, p, n_segment: int, n_div: int):
        args = (x, p["w1"], p["w2"], p["w3"], p["s1"], p["b1"], p["s2"],
                p["b2"], p["s3"], p["b3"])
        if self.stride == 2:
            return tsm_bottleneck_s2(*args, p["wp"], p["sp"], p["bp"],
                                     n_segment, n_div)
        return tsm_bottleneck(*args, n_segment, n_div, p["wp"], p["sp"],
                              p["bp"])


class ResNet(nn.Module):
    """ResNet-50/101 backbone -> pooled features [N, 2048] (inference).

    n_segment > 0 shifts every block in time (N = clips * n_segment,
    frames time-major per clip). stem_input "s2d": x is the 4x4
    space-to-depth pack [N, H/4, W/4, 48] of raw uint8 pixels (the stem
    kernel normalizes); "frames": x is normalized [N, H, W, 3] float.
    dtype is the compute type; parameters stay float32 and are folded
    and cast once, on first use after a load or a move.

    `act_scales` is None, or, in the W8A8 twin that `quantized` makes, a
    dict from block name ("layer2.1") to its (sx, sz, sy2, sout); a block
    without an entry takes unit scales, as the JAX package's "quant"
    collection initializes them.

    tsm_impl and fuse_tsm: see the module docstring; both may be set
    again after construction. remat (the JAX package's
    model.remat_vision) and chain_blocks: see the module docstring."""

    feature_dim = 2048

    def __init__(self, depth: int = 50, n_segment: int = 0, n_div: int = 8,
                 stem_input: str = "frames",
                 stage_sizes: Optional[Sequence[int]] = None,
                 dtype: torch.dtype = torch.float32, tsm_impl="auto",
                 fuse_tsm: bool = True, remat: bool = False,
                 chain_blocks: bool = False):
        super().__init__()
        if stem_input not in ("s2d", "frames"):
            raise ValueError(f"stem_input {stem_input!r}: 's2d' or 'frames'")
        self.remat = remat
        self.chain_blocks = chain_blocks
        self.n_segment, self.n_div = n_segment, n_div
        self.stem_input, self.dtype = stem_input, dtype
        self.act_scales: Optional[Dict[str, torch.Tensor]] = None
        self.stage_sizes = tuple(stage_sizes or STAGE_SIZES[depth])
        self.tsm_impl = tsm_impl
        self.fuse_tsm = fuse_tsm
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64, eps=BN_EPS)
        cin = 64
        for stage, n_blocks in enumerate(self.stage_sizes):
            f = 64 * 2 ** stage
            blocks = []
            for b in range(n_blocks):
                stride = 2 if stage > 0 and b == 0 else 1
                blocks.append(Bottleneck(cin, f, stride, projection=b == 0))
                cin = 4 * f
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
        self._folded = None

    @property
    def tsm_impl(self):
        return self._tsm_impl

    @tsm_impl.setter
    def tsm_impl(self, value):
        self._tsm_impl = check_tsm_impl(value, len(self.stage_sizes))

    def stage_impls(self) -> Tuple[str, ...]:
        """tsm_impl per stage."""
        if isinstance(self.tsm_impl, str):
            return (self.tsm_impl,) * len(self.stage_sizes)
        return self.tsm_impl

    def _kernel_stem_train(self) -> bool:
        """Training takes the K11 stem (JAX :651-668)."""
        return ("fusedtrain" in self.stage_impls()
                or (self.tsm_impl == "auto" and self.fuse_tsm
                    and self.n_segment > 0))

    def _trunk_train(self) -> bool:
        """Training takes the kernel trunk (JAX :729-746)."""
        return (self.tsm_impl in ("auto", "fusedtrain") and self.fuse_tsm
                and self.n_segment > 0 and not self.remat)

    def eval_route(self, stage: int, blk: "Bottleneck") -> str:
        """A block's inference route: "block" (the whole-block kernels),
        "k5", "tap3", "xla" or "unfused" (K7, then a plain conv1)."""
        impl = self.stage_impls()[stage]
        whole = impl in ("auto", "fusedtrain", "fusedall") or (
            impl == "fusedblk" and blk.stride == 1 and blk.downsample is None)
        if self.fuse_tsm and whole:
            return "block"
        if not self.fuse_tsm or self.n_segment == 0:
            return "unfused"
        return "k5" if impl in _K5_IMPLS else impl

    def blocks(self) -> List[Bottleneck]:
        return [blk for s in range(len(self.stage_sizes))
                for blk in getattr(self, f"layer{s + 1}")]

    def block_names(self) -> List[str]:
        """Module names of blocks(), in order ("layer1.0", ...)."""
        return [f"layer{s + 1}.{b}" for s, n in enumerate(self.stage_sizes)
                for b in range(n)]

    def quantized(self, act_scales: Dict[str, torch.Tensor]) -> "ResNet":
        """The W8A8 twin (the JAX package's clone(quantize=True) applied
        with a "quant" collection): a shallow copy that shares this
        model's parameters and buffers, with its own act_scales."""
        twin = copy.copy(self)
        twin.act_scales = dict(act_scales)
        twin._folded = twin._quant_folded = None
        return twin

    def _links(self, hw) -> List[bool]:
        """links[s]: stage s's last block feeds stage s+1's block0 on the
        W8A8 stride-2 route (JAX models/resnet.py:765-782, where the link
        is a planar layout; here a route condition). hw: the stem output's
        (H, W). It holds when the producer is stride 1, both ends take the
        whole-block route and the consumer's input H and W are even."""
        links = []
        h, w = hw
        for s in range(len(self.stage_sizes) - 1):
            if s > 0:  # stage s's output: its block0 halves (pad 1, 3x3)
                h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1
            prod = getattr(self, f"layer{s + 1}")[-1]
            cons = getattr(self, f"layer{s + 2}")[0]
            links.append(h % 2 == 0 and w % 2 == 0 and prod.stride == 1
                         and self.n_segment > 0
                         and self.eval_route(s, prod) == "block"
                         and self.eval_route(s + 1, cons) == "block")
        return links

    def _quant_plan(self, capture, hw=None) -> List[Optional[str]]:
        """Per block: None (bf16 kernels), "s2" (the W8A8 stride-2 block0,
        int8 out) or the int8 kernel's out_mode (JAX models/resnet.py:
        785-800, 846-855). No stage quantizes while capturing (the
        calibration reads float activations). The stride-2 block0s and
        the int8 tails need INT8_S2_BLOCKS and the stem output's (H, W),
        hw; without hw none is planned."""
        sizes = self.stage_sizes
        quant = [self.act_scales is not None and stage > 0 and n >= 2
                 and capture is None and self.n_segment > 0 and self.fuse_tsm
                 for stage, n in enumerate(sizes)]
        links = (self._links(hw) if INT8_S2_BLOCKS and hw is not None
                 else [False] * (len(sizes) - 1))
        plan: List[Optional[str]] = []
        for stage, n in enumerate(sizes):
            plan.append("s2" if quant[stage] and links[stage - 1] else None)
            if not quant[stage]:
                plan += [None] * (n - 1)
                continue
            # the tail emits int8 when the next stage's block0 takes it
            tail = ("i8" if stage + 1 < len(sizes) and links[stage]
                    and quant[stage + 1] else "bf16")
            plan += ["i8"] * (n - 2) + [tail]
        return plan

    def _chained(self, plan, capture) -> List[bool]:
        """Per stage: blocks 1.. run as one chain (chain_blocks; JAX
        :805-831): eval, no capture, at least 3 blocks, none quantized,
        all on the whole-block route."""
        out = []
        i = 0
        for stage, n in enumerate(self.stage_sizes):
            layer = getattr(self, f"layer{stage + 1}")
            out.append(self.chain_blocks and capture is None and n >= 3
                       and self.n_segment > 0
                       and not any(plan[i:i + n])
                       and all(self.eval_route(stage, blk) == "block"
                               for blk in list(layer)[1:]))
            i += n
        return out

    def quant_params(self, plan=None) -> List[Optional[QuantBottleneck]]:
        """Bottleneck.quantized (quantized_s2 for an "s2" block0) of each
        block the plan quantizes (None elsewhere), made once per fold, per
        plan and per set of act_scales. plan: _quant_plan's, by default
        the one without stride-2 blocks."""
        self.folded_params()  # refreshes the fold key
        names = self.block_names()
        plan = self._quant_plan(None) if plan is None else plan
        scales = {n: (self.act_scales[n] if n in self.act_scales
                      else torch.ones(4)) for n, m in zip(names, plan) if m}
        key = (self._folded[0], tuple(plan), tuple(
            (n, tuple(torch.as_tensor(v).float().reshape(-1).tolist()))
            for n, v in scales.items()))
        if self._quant_folded is None or self._quant_folded[0] != key:
            with torch.no_grad():
                qs = [None if m is None
                      else blk.quantized_s2(scales[n]) if m == "s2"
                      else blk.quantized(scales[n])
                      for n, m, blk in zip(names, plan, self.blocks())]
            self._quant_folded = (key, qs)
        return self._quant_folded[1]

    def _load_from_state_dict(self, *args, **kwargs):
        self._folded = None  # new weights: fold again on next use
        self._quant_folded = None
        super()._load_from_state_dict(*args, **kwargs)

    def folded_params(self):
        """(stem, blocks): the kernel-ready weights in self.dtype and the
        folded BN in float32, built once per load, device, dtype and
        version of the parameters and statistics (an optimizer step or a
        training forward updates them in place and bumps their versions,
        so the next eval folds again)."""
        version = sum(t._version for t in self.parameters())
        version += sum(t._version for t in self.buffers())
        key = (self.conv1.weight.device, self.dtype, version)
        if self._folded is None or self._folded[0] != key:
            with torch.no_grad():
                s, b = fold_bn(self.bn1)
                stem = {"w7": _hwio(self.conv1, self.dtype), "s": s, "b": b}
                self._folded = (key, stem,
                                [blk.folded(self.dtype)
                                 for blk in self.blocks()])
        return self._folded[1], self._folded[2]

    def forward(self, x: torch.Tensor, from_stage: int = 0,
                capture: Optional[dict] = None) -> torch.Tensor:
        """from_stage and capture (JAX models/resnet.py:604-613): see
        forward_eval; training takes neither."""
        if self.training:
            if from_stage or capture is not None:
                raise ValueError("from_stage and capture are inference "
                                 "options")
            return self.forward_train(x)
        return self.forward_eval(x, capture, from_stage)

    def forward_train(self, x: torch.Tensor) -> torch.Tensor:
        """Training forward with batch-statistics BatchNorm; updates the
        running averages. x as for forward; returns [N, 2048] in
        self.dtype, differentiable in every parameter."""
        dt = self.dtype
        blocks = self.blocks()
        if self._kernel_stem_train():
            w7 = _hwio_view(self.conv1)
            g, b = self.bn1.weight, self.bn1.bias
            if self.stem_input == "s2d":
                y, stem_stats = stem_s2d_train(x, w7, g, b, BN_EPS, dt)
            else:
                y, stem_stats = stem_frames_train(x.to(dt), w7, g, b, BN_EPS,
                                                  dt)
        else:
            y, stem_stats = self._plain_stem_train(x)
        update_running(self.bn1, *stem_stats)
        if self._trunk_train():
            y, stats = tsm_trunk_train(
                y, [blk.train_params() for blk in blocks],
                [blk.kind() for blk in blocks], self.n_segment, self.n_div,
                BN_EPS)
        else:
            stats = []
            for stage, blk in zip(self._block_stages(), blocks):
                if self.remat:
                    # the first forward's statistics move the running
                    # averages below; the recomputation's are dropped
                    y, st = checkpoint(self._block_train, stage, blk, y,
                                       use_reentrant=False)
                else:
                    y, st = self._block_train(stage, blk, y)
                stats.append(st)
        for blk, st in zip(blocks, stats):
            for i, bn in enumerate(blk.batch_norms()):
                update_running(bn, st[2 * i], st[2 * i + 1])
        # global average pool, at least float32 sum
        return at_least_f32(y).mean(dim=(1, 2)).to(dt)

    def _block_stages(self) -> List[int]:
        return [s for s, n in enumerate(self.stage_sizes) for _ in range(n)]

    def _plain_stem_train(self, x):
        """The stem as plain torch ops (JAX :658-668, 714-725): s2d input
        unpacked and, if uint8, normalized (K6 on the card); 7x7/2 conv,
        batch-stat BN, ReLU, 3x3/2 max pool."""
        dt = self.dtype
        if self.stem_input == "s2d":
            frames = depth_to_space4(x)
            frames = (normalize_frames(frames, dt) if x.dtype == torch.uint8
                      else frames.to(dt))
        else:
            frames = x.to(dt)
        a, mu, var = bn_train(conv_nhwc(frames, _hwio_view(self.conv1), 2, 3),
                              self.bn1.weight, self.bn1.bias, BN_EPS)
        y = F.max_pool2d(torch.relu(a).permute(0, 3, 1, 2), 3, stride=2,
                         padding=1)
        return y.permute(0, 2, 3, 1), (mu, var)

    def _block_train(self, stage: int, blk: "Bottleneck", x):
        """One block of the per-block training path -> (y, stats)."""
        t, nd = self.n_segment, self.n_div
        impl = self.stage_impls()[stage]
        params = unpack(blk.train_params(), blk.kind())
        if not self.fuse_tsm or t == 0:
            def conv1(x, w1):
                return conv_nhwc(temporal_shift(x, t, nd) if t else x, w1)
        elif impl in ("auto", "fusedtrain"):
            return _block(x, params, blk.stride, t, nd, BN_EPS)
        elif impl in _K5_IMPLS:
            def conv1(x, w1):
                return tsm_conv1x1(x, w1, t, nd)
        else:
            form = (temporal_shift_conv1x1_3tap if impl == "tap3"
                    else temporal_shift_conv1x1)

            def conv1(x, w1):
                return form(x, w1.to(x.dtype), t, nd)
        w1, w2, w3, wp, g1, be1, g2, be2, g3, be3, gp, bep = params
        return tsm_block_train_reference(
            x, w1, w2, w3, g1, be1, g2, be2, g3, be3, t, nd, BN_EPS, wp, gp,
            bep, blk.stride, conv1=conv1)

    def forward_eval(self, x: torch.Tensor, capture: Optional[dict] = None,
                     from_stage: int = 0) -> torch.Tensor:
        """Inference forward -> pooled features [N, 2048]. capture: a dict
        that receives the stem output under "stem" and each stage's output
        under "stage{i}" (JAX models/resnet.py:604-613, 726-727, 858-859).

        from_stage = s > 0 skips the stem and the first s stages: x is the
        output of stage s (capture["stage{s}"]), and at the last stage only
        the pool remains (Grad-CAM re-enters there, JAX :801-803). A
        re-entry runs under the caller's grad mode, differentiable in x
        on routes that have a backward: the plain ones ("tap3", "xla") and,
        on the CPU, every route; the whole-block and K5 inference kernels
        have none, and their wrappers raise on a CUDA input that needs a
        gradient. A forward from the stem runs without gradients."""
        if from_stage == 0:
            with torch.no_grad():
                return self._forward_eval(x, capture, 0)
        return self._forward_eval(x, capture, from_stage)

    def _forward_eval(self, x, capture, from_stage):
        if not 0 <= from_stage <= len(self.stage_sizes):
            raise ValueError(f"from_stage {from_stage}: 0 to "
                             f"{len(self.stage_sizes)}")
        stem, blocks = self.folded_params()
        if from_stage:
            return self._stages(x, blocks, capture, from_stage)
        if self.stem_input == "s2d" and x.dtype == torch.uint8:
            y = stem_s2d(x, stem["w7"], stem["s"], stem["b"],
                         out_dtype=self.dtype)
        else:
            frames = depth_to_space4(x) if self.stem_input == "s2d" else x
            y = stem_frames(frames.to(self.dtype).contiguous(), stem["w7"],
                            stem["s"], stem["b"])
        if capture is not None:
            capture["stem"] = y
        return self._stages(y, blocks, capture, 0)

    def _stages(self, y, blocks, capture, from_stage: int):
        """Stages from_stage + 1.. on y, then the pool."""
        plan = self._quant_plan(capture if from_stage == 0 else {},
                                tuple(y.shape[1:3]))
        quant = self.quant_params(plan) if any(plan) else [None] * len(plan)
        chained = self._chained(plan, capture if from_stage == 0 else {})
        start = 0
        for stage, n in enumerate(self.stage_sizes):
            if stage < from_stage:
                start += n
                continue
            layer = list(getattr(self, f"layer{stage + 1}"))
            for b, blk in enumerate(layer):
                i = start + b
                if b == 1 and chained[stage]:
                    y = tsm_bottleneck_chain(
                        y, [layer[k].chain_params(blocks[start + k])
                            for k in range(1, n)],
                        self.n_segment, self.n_div)
                    break
                if plan[i] == "s2":
                    y = int8_s2_bottleneck(y, quant[i], self.n_segment,
                                           self.n_div, "i8", self.dtype)
                elif plan[i]:
                    y = int8_bottleneck(y, quant[i], self.n_segment,
                                        self.n_div, plan[i], self.dtype)
                else:
                    y = self._block_eval(stage, blk, blocks[i], y)
            start += n
            if capture is not None:
                capture[f"stage{stage + 1}"] = y
        # global average pool (torchvision avgpool + flatten), f32 sum
        return y.float().mean(dim=(1, 2)).to(self.dtype)

    def _block_eval(self, stage: int, blk: "Bottleneck", p: dict, x):
        """One block at inference, by its eval_route."""
        route = self.eval_route(stage, blk)
        if route == "block":
            return blk.run(x, p, self.n_segment, self.n_div)
        t, nd = self.n_segment, self.n_div
        if route == "k5":
            y1 = tsm_conv1x1_bn_relu(x, p["w1"], p["s1"], p["b1"], t, nd)
        else:
            if route == "tap3":
                y = temporal_shift_conv1x1_3tap(x, p["w1"], t, nd)
            elif route == "xla":
                y = temporal_shift_conv1x1(x, p["w1"], t, nd)
            else:
                y = (temporal_shift(x, t, nd) if t else x) @ p["w1"]
            y1 = torch.relu(y * p["s1"] + p["b1"]).to(x.dtype)
        return bottleneck_tail_reference(
            y1, x, p["w2"], p["w3"], p["s2"], p["b2"], p["s3"], p["b3"],
            p["wp"], p["sp"], p["bp"], blk.stride)



class Resnet50TSM(nn.Module):
    """Vision embedder: [B, T, ...] frames (or the s2d pack) -> features
    [B, T, 2048] (JAX models/resnet.py:919-959, without the head)."""

    def __init__(self, segments_size: int = 16, shift_div: int = 8,
                 stem_input: str = "frames",
                 stage_sizes: Optional[Sequence[int]] = None,
                 dtype: torch.dtype = torch.float32, tsm_impl="auto",
                 fuse_tsm: bool = True):
        super().__init__()
        self.base_model = ResNet(50, n_segment=segments_size,
                                 n_div=shift_div, stem_input=stem_input,
                                 stage_sizes=stage_sizes, dtype=dtype,
                                 tsm_impl=tsm_impl, fuse_tsm=fuse_tsm)

    def quantized(self, quant: Dict[str, Dict[str, torch.Tensor]]
                  ) -> "Resnet50TSM":
        """The W8A8 twin (JAX clone(quantize=True) with the "quant"
        collection of ops/quantize.py:calibrate_tsm_quant): a shallow copy
        whose trunk is base_model.quantized(quant["base_model"])."""
        twin = copy.copy(self)
        twin._modules = copy.copy(self._modules)
        twin._modules["base_model"] = self.base_model.quantized(
            quant["base_model"])
        return twin

    def features(self, x: torch.Tensor) -> torch.Tensor:
        b, t = x.shape[0], x.shape[1]
        out = self.base_model(x.reshape(b * t, *x.shape[2:]))
        return out.reshape(b, t, -1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.features(x)
