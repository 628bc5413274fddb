"""Post-training W8A8 calibration and weight-only int8 (counterpart of
the JAX package's ops/quantize.py).

`calibrate_resnet_quant` runs the model (its kernel trunk, on the card)
with the capture hook, then reruns the plain bottleneck math of
:49-81 (F.conv2d; XLA in the JAX package, no kernel) to collect each
block's activation abs-max and returns per block (sx, sz, sy2, sout):

  sx   input scale (== the previous block's output scale: same tensor)
  sz   conv2 input (relu(bn1 conv1))
  sy2  conv3 input (relu(bn2 conv2))
  sout block output

keyed by the block's module name ("layer2.1"), for ResNet.quantized.
`calibrate_tsm_quant` and `calibrate_two_stream_quant` calibrate the
trunk inside the vision embedder and the boundary scorer.
`quantize_seq2seq` maps a float title-model state dict to the int8 one that
a Seq2Seq built with weight_quant=True loads (models/quant_layers.py).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..models.quant_layers import quantize_weight
from .preprocess import normalize_frames
from .temporal_shift import temporal_shift_reference


def _amax(v: torch.Tensor) -> torch.Tensor:
    """max |v| in float32."""
    return v.float().abs().max()


def _same_pad(n: int, stride: int):
    """XLA's "SAME" padding (lo, hi) of a 3-wide window over n."""
    total = max((-(-n // stride) - 1) * stride + 3 - n, 0)
    return total // 2, total - total // 2


def _block_forward(x, blk, stride: int, proj: bool, n_segment: int,
                   n_div: int):
    """The bottleneck in x.dtype with folded BN (quantize.py:49-81) ->
    (out, (amax y1, amax y2, amax out)). The 3x3 pads as the JAX
    calibration's "SAME" does: (1, 1) at stride 1, but (0, 1) at stride 2
    on even sizes, where the model itself pads (1, 1) (ROADMAP queue 3)."""
    from ..models.resnet import _hwio, fold_bn

    dt = x.dtype
    col = lambda v: v.float()  # noqa: E731  (NHWC: broadcasts on C)
    s1, b1 = fold_bn(blk.bn1)
    s2, b2 = fold_bn(blk.bn2)
    s3, b3 = fold_bn(blk.bn3)
    y = temporal_shift_reference(x, n_segment, n_div)
    y = y @ _hwio(blk.conv1, dt)
    y1 = torch.relu(y * col(s1) + col(b1)).to(dt)
    w2 = _hwio(blk.conv2, dt).permute(3, 2, 0, 1)
    pad = (*_same_pad(y1.shape[2], stride), *_same_pad(y1.shape[1], stride))
    y = F.conv2d(F.pad(y1.permute(0, 3, 1, 2), pad), w2, stride=stride)
    y2 = torch.relu(y.permute(0, 2, 3, 1) * col(s2) + col(b2)).to(dt)
    y3 = (y2 @ _hwio(blk.conv3, dt)) * col(s3) + col(b3)
    res = x
    if proj:
        sp, bp = fold_bn(blk.downsample[1])
        r = x[:, ::stride, ::stride] if stride > 1 else x
        res = (r @ _hwio(blk.downsample[0], dt)) * col(sp) + col(bp)
    out = torch.relu(y3 + res).to(dt)
    return out, (_amax(y1), _amax(y2), _amax(out))


@torch.no_grad()
def calibrate_resnet_quant(model, frames: torch.Tensor
                           ) -> Dict[str, torch.Tensor]:
    """Run `model` (a models.resnet.ResNet, eval) over calibration
    `frames` ([N*T, H, W, 3] normalized, or the s2d uint8 pack for
    stem_input='s2d') and return its act_scales: block name -> float32
    [4] on the CPU, every block of every stage (block0s too, as
    quantize.py:84-140 emits them)."""
    was_training = model.training
    model.eval()
    capture: dict = {}
    model(frames, capture=capture)
    model.train(was_training)
    eps = 1e-6
    out: Dict[str, torch.Tensor] = {}
    for stage, n_blocks in enumerate(model.stage_sizes):
        layer = getattr(model, f"layer{stage + 1}")
        x = capture["stem"] if stage == 0 else capture[f"stage{stage}"]
        sx = _amax(x) / 127.0
        for b in range(n_blocks):
            stride = 2 if stage > 0 and b == 0 else 1
            x, (a1, a2, ao) = _block_forward(
                x, layer[b], stride, b == 0, model.n_segment, model.n_div)
            out[f"layer{stage + 1}.{b}"] = torch.clamp(torch.stack(
                [sx, a1 / 127.0, a2 / 127.0, ao / 127.0]), min=eps).cpu()
            sx = ao / 127.0  # the next block's input IS this output
    return out


def _calibrate_clips(vision, clips: torch.Tensor
                     ) -> Dict[str, torch.Tensor]:
    """calibrate_resnet_quant over clips [B, T, ...] on the trunk's
    device: the uint8 s2d pack for an s2d stem, else frames (uint8 frames
    are normalized here, to the trunk's dtype)."""
    flat = clips.reshape(-1, *clips.shape[2:])
    if vision.stem_input != "s2d" and flat.dtype == torch.uint8:
        flat = normalize_frames(flat, vision.dtype)
    return calibrate_resnet_quant(vision, flat)


def calibrate_tsm_quant(model50, clips: torch.Tensor
                        ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Calibration for the Resnet50TSM embedder (quantize.py:143-163):
    clips [B, T, ...] as for _calibrate_clips -> {"base_model":
    act_scales}, for Resnet50TSM.quantized."""
    return {"base_model": _calibrate_clips(model50.base_model, clips)}


def calibrate_two_stream_quant(model, clips: torch.Tensor
                               ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Calibration for a TwoStream boundary scorer (quantize.py:166):
    clips [B, T, ...] as for _calibrate_clips -> {"vision_model":
    act_scales}."""
    return {"vision_model": _calibrate_clips(model.vision_model, clips)}


def _core_key(key: str) -> str:
    """The key inside the Seq2Seq core: without the `seq2seq.` prefix of a
    Seq2SeqVisionEmb state dict (quantize.py:219-223 transforms the core
    at any nesting depth)."""
    return key[len("seq2seq."):] if key.startswith("seq2seq.") else key


def _in_core(key: str) -> bool:
    """Linear weights of the encoder and decoder layers (quantize.py:215:
    enc_layer*/dec_layer*; the port's tied head has no lm_head)."""
    return _core_key(key).startswith(("model.encoder.layers.",
                                      "model.decoder.layers."))


def quantize_seq2seq(state_dict: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """Weight-only int8 form of a float title-model state dict (Pegasus,
    BigBird or BART; quantize.py:192): every 2-d Linear `weight` [out, in]
    of the layers becomes `weight_q` int8 and `scale` float32 [out] (per
    output channel, the JAX kernel's axis 0), and the shared table
    `model.shared.weight` becomes `model.shared.embedding_q` and
    `model.shared.scale` (per vocab row). Everything else passes through:
    biases (where the layers have them), LayerNorms, learned position
    tables (`model.*.embed_positions`, outside the layers) and
    final_logits_bias. Load the result into a Seq2Seq built from
    dataclasses.replace(cfg, weight_quant=True). A Seq2SeqVisionEmb state
    dict quantizes the same way under its `seq2seq.` prefix; its fusion
    head stays float, as in the JAX package."""
    out: Dict[str, torch.Tensor] = {}
    for key, v in state_dict.items():
        if key.endswith(".weight") and v.dim() == 2 and _in_core(key):
            q, s = quantize_weight(v.t(), axis=0)
            out[key[:-len("weight")] + "weight_q"] = q.t().contiguous()
            out[key[:-len("weight")] + "scale"] = s
        elif _core_key(key) == "model.shared.weight":
            q, s = quantize_weight(v, axis=1)
            out[key[:-len("weight")] + "embedding_q"] = q
            out[key[:-len("weight")] + "scale"] = s
        else:
            out[key] = v
    return out
