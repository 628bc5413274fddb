"""ResNet-50 with Temporal Shift Module, inference (counterpart of the JAX
package's models/resnet.py).

Parameters and buffers carry torchvision's names and layouts
(`conv1.weight`, `layer1.0.downsample.1.running_var`, ...), so the JAX
package's `convert_torchvision_resnet50` reads this state dict as it is.
The forward is inference only: BatchNorm folds into a per-channel scale
and bias (eps 1e-5) and every bottleneck runs as one call of the fused
kernel wrappers in ops/ (stem_s2d, tsm_bottleneck, tsm_bottleneck_s2),
NHWC throughout. The stride sits on the 3x3 (v1.5); the projection is a
1x1 with the block's stride on the unshifted input. Every block shifts
('blockres' TSM on conv1's input).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from ..ops.preprocess import depth_to_space4
from ..ops.stem import stem_frames_reference, stem_s2d
from ..ops.tsm_block import tsm_bottleneck, tsm_bottleneck_s2

STAGE_SIZES = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}
BN_EPS = 1e-5


def fold_bn(bn: nn.BatchNorm2d):
    """Inference BatchNorm as (scale, bias), float32."""
    s = bn.weight.float() * torch.rsqrt(bn.running_var.float() + BN_EPS)
    return s, bn.bias.float() - bn.running_mean.float() * s


def _hwio(conv: nn.Conv2d, dtype) -> torch.Tensor:
    """OIHW conv weight -> HWIO (1x1: [Cin, Cout]) in dtype, contiguous."""
    w = conv.weight.permute(2, 3, 1, 0)
    if w.shape[0] == 1 and w.shape[1] == 1:
        w = w[0, 0]
    return w.to(dtype).contiguous()


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
    and cast once, on first use after a load or a move."""

    feature_dim = 2048

    def __init__(self, depth: int = 50, n_segment: int = 0, n_div: int = 8,
                 stem_input: str = "frames",
                 stage_sizes: Optional[Sequence[int]] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if stem_input not in ("s2d", "frames"):
            raise ValueError(f"stem_input {stem_input!r}: 's2d' or 'frames'")
        self.n_segment, self.n_div = n_segment, n_div
        self.stem_input, self.dtype = stem_input, dtype
        self.stage_sizes = tuple(stage_sizes or STAGE_SIZES[depth])
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

    def blocks(self) -> List[Bottleneck]:
        return [blk for s in range(len(self.stage_sizes))
                for blk in getattr(self, f"layer{s + 1}")]

    def _load_from_state_dict(self, *args, **kwargs):
        self._folded = None  # new weights: fold again on next use
        super()._load_from_state_dict(*args, **kwargs)

    def folded_params(self):
        """(stem, blocks): the kernel-ready weights in self.dtype and the
        folded BN in float32, built once per load, device and dtype."""
        key = (self.conv1.weight.device, self.dtype)
        if self._folded is None or self._folded[0] != key:
            with torch.no_grad():
                s, b = fold_bn(self.bn1)
                stem = {"w7": _hwio(self.conv1, self.dtype), "s": s, "b": b}
                self._folded = (key, stem,
                                [blk.folded(self.dtype)
                                 for blk in self.blocks()])
        return self._folded[1], self._folded[2]

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        stem, blocks = self.folded_params()
        if self.stem_input == "s2d" and x.dtype == torch.uint8:
            y = stem_s2d(x, stem["w7"], stem["s"], stem["b"],
                         out_dtype=self.dtype)
        else:
            frames = depth_to_space4(x) if self.stem_input == "s2d" else x
            y = stem_frames_reference(frames.to(self.dtype), stem["w7"],
                                      stem["s"], stem["b"])
        for blk, p in zip(self.blocks(), blocks):
            y = blk.run(y, p, self.n_segment, self.n_div)
        # global average pool (torchvision avgpool + flatten), f32 sum
        return y.float().mean(dim=(1, 2)).to(self.dtype)


class Resnet50TSM(nn.Module):
    """Vision embedder: [B, T, ...] frames -> features [B, T, 2048]."""

    def __init__(self, segments_size: int = 16, shift_div: int = 8,
                 stem_input: str = "frames",
                 stage_sizes: Optional[Sequence[int]] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.base_model = ResNet(50, n_segment=segments_size,
                                 n_div=shift_div, stem_input=stem_input,
                                 stage_sizes=stage_sizes, dtype=dtype)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        b, t = x.shape[0], x.shape[1]
        out = self.base_model(x.reshape(b * t, *x.shape[2:]))
        return out.reshape(b, t, -1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.features(x)
