"""Plain PyTorch forward passes of the benchmarked models, written from
their published descriptions and read from a state dict by name.

Nothing here imports the program under test: the functions take a dict
of tensors (the weights the benchmark made from the seed, upcast to
float32) and inputs the benchmark made, and compute in float32 with
TF32 off (inside `exact_matmuls`). `Prec` puts every matrix product and
convolution through a lower precision for the control run: float8
e4m3 with one scale per tensor, the step below the configuration's
bfloat16.

Layouts follow the state dict's own keys (torchvision's ResNet names,
HuggingFace's BERT names); convolutions run in NCHW, as F.conv2d takes
them. BatchNorm uses its running statistics: every pass here is
inference.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Sequence

import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
FP8_MAX = 448.0  # float8_e4m3fn's largest finite value


@contextlib.contextmanager
def exact_matmuls():
    """float32 products in float32 inside the block: TF32 off for
    matmuls and cuDNN, restored after."""
    was = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = was


class Prec:
    """The precision of the reference's products: "fp32", or "fp8" (each
    operand of a matmul or convolution scaled by its own absolute max to
    e4m3's range, rounded to float8_e4m3fn and back; the product itself
    in float32)."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"precision {name!r}: fp32 or fp8")
        self.name = name

    def q(self, t: torch.Tensor) -> torch.Tensor:
        if self.name == "fp32":
            return t
        scale = t.abs().amax().clamp(min=1e-30) / FP8_MAX
        return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale

    def linear(self, x, w, b=None):
        y = self.q(x) @ self.q(w).t()
        return y if b is None else y + b

    def matmul(self, a, b):
        return self.q(a) @ self.q(b)

    def conv(self, x, w, stride=1, padding=0):
        return F.conv2d(self.q(x), self.q(w), stride=stride, padding=padding)


FP32 = Prec("fp32")


def layer_norm(x, w, b, eps):
    return F.layer_norm(x, x.shape[-1:], w, b, eps)


# ---------------------------------------------------------------------------
# BERT (google-bert/bert-base-uncased: post-norm encoder, exact GELU)
# ---------------------------------------------------------------------------


def bert(sd: Weights, p: str, ids: torch.Tensor, mask: torch.Tensor,
         cfg: dict, prec: Prec = FP32):
    """ids, mask [B, L] -> (hidden [B, L, H], pooled [B, H]). Token type 0
    everywhere; a pad key gets -10000 before the softmax."""
    eps, nh = cfg["layer_norm_eps"], cfg["num_heads"]
    b, l = ids.shape
    x = (sd[f"{p}embeddings.word_embeddings.weight"][ids]
         + sd[f"{p}embeddings.position_embeddings.weight"][:l][None]
         + sd[f"{p}embeddings.token_type_embeddings.weight"][0])
    x = layer_norm(x, sd[f"{p}embeddings.LayerNorm.weight"],
                   sd[f"{p}embeddings.LayerNorm.bias"], eps)
    bias = (1.0 - mask[:, None, None, :].float()) * -10000.0
    for i in range(cfg["num_layers"]):
        q = f"{p}encoder.layer.{i}."
        lin = lambda t, n: prec.linear(t, sd[q + n + ".weight"],  # noqa: E731
                                       sd[q + n + ".bias"])
        heads = lambda t: t.reshape(b, l, nh, -1).transpose(1, 2)  # noqa: E731
        qh = heads(lin(x, "attention.self.query"))
        kh = heads(lin(x, "attention.self.key"))
        vh = heads(lin(x, "attention.self.value"))
        att = prec.matmul(qh, kh.transpose(-1, -2)) / math.sqrt(qh.shape[-1])
        ctx = prec.matmul(torch.softmax(att + bias, -1), vh)
        ctx = ctx.transpose(1, 2).reshape(b, l, -1)
        x = layer_norm(lin(ctx, "attention.output.dense") + x,
                       sd[q + "attention.output.LayerNorm.weight"],
                       sd[q + "attention.output.LayerNorm.bias"], eps)
        h = F.gelu(lin(x, "intermediate.dense"))
        x = layer_norm(lin(h, "output.dense") + x,
                       sd[q + "output.LayerNorm.weight"],
                       sd[q + "output.LayerNorm.bias"], eps)
    pooled = torch.tanh(prec.linear(x[:, 0], sd[f"{p}pooler.dense.weight"],
                                    sd[f"{p}pooler.dense.bias"]))
    return x, pooled


# ---------------------------------------------------------------------------
# ResNet-50 with the temporal shift module (arXiv:1811.08383, "blockres")
# ---------------------------------------------------------------------------


def normalize_u8(frames_u8: torch.Tensor) -> torch.Tensor:
    """[N, H, W, 3] uint8 -> ImageNet-normalized [N, 3, H, W] float32."""
    x = frames_u8.float().permute(0, 3, 1, 2) / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)[None, :, None, None]
    std = torch.tensor(IMAGENET_STD, device=x.device)[None, :, None, None]
    return (x - mean) / std


def temporal_shift(x: torch.Tensor, t: int, n_div: int) -> torch.Tensor:
    """x [N*T, C, H, W], frames time-major per clip: channel fold 0 takes
    frame t + 1, fold 1 frame t - 1 (zeros past either end), the rest
    stay."""
    nt, c, h, w = x.shape
    x = x.reshape(nt // t, t, c, h, w)
    fold = c // n_div
    out = torch.zeros_like(x)
    out[:, :-1, :fold] = x[:, 1:, :fold]
    out[:, 1:, fold:2 * fold] = x[:, :-1, fold:2 * fold]
    out[:, :, 2 * fold:] = x[:, :, 2 * fold:]
    return out.reshape(nt, c, h, w)


def batch_norm(x, sd: Weights, p: str, eps: float = 1e-5):
    """BatchNorm with its running statistics."""
    mu, var = sd[p + "running_mean"], sd[p + "running_var"]
    inv = torch.rsqrt(var + eps) * sd[p + "weight"]
    return ((x - mu[None, :, None, None]) * inv[None, :, None, None]
            + sd[p + "bias"][None, :, None, None])


def bottleneck(x, sd: Weights, p: str, stride: int, proj: bool, t: int,
               n_div: int, prec: Prec = FP32):
    """torchvision's v1.5 bottleneck (stride on the 3x3) with the shift on
    conv1's input; the projection takes the unshifted input."""
    y = temporal_shift(x, t, n_div) if t else x
    y = torch.relu(batch_norm(prec.conv(y, sd[p + "conv1.weight"]), sd,
                              p + "bn1."))
    y = torch.relu(batch_norm(prec.conv(y, sd[p + "conv2.weight"], stride, 1),
                              sd, p + "bn2."))
    y = batch_norm(prec.conv(y, sd[p + "conv3.weight"]), sd, p + "bn3.")
    short = x
    if proj:
        short = batch_norm(prec.conv(x, sd[p + "downsample.0.weight"], stride),
                           sd, p + "downsample.1.")
    return torch.relu(y + short)


def resnet_stem(frames_u8, sd: Weights, p: str, prec: Prec = FP32):
    x = normalize_u8(frames_u8)
    x = torch.relu(batch_norm(prec.conv(x, sd[p + "conv1.weight"], 2, 3), sd,
                              p + "bn1."))
    return F.max_pool2d(x, 3, stride=2, padding=1)


def resnet_blocks(stage_sizes: Sequence[int]):
    """(name, stride, projection) of every bottleneck, in order."""
    out = []
    for s, n in enumerate(stage_sizes):
        for b in range(n):
            out.append((f"layer{s + 1}.{b}.", 2 if s > 0 and b == 0 else 1,
                        b == 0))
    return out


def resnet_tsm(frames_u8: torch.Tensor, sd: Weights, p: str, cfg: dict,
               prec: Prec = FP32) -> torch.Tensor:
    """frames [N*T, H, W, 3] uint8 -> pooled features [N*T, 2048]
    float32."""
    t, n_div = cfg["n_segment"], cfg["n_div"]
    y = resnet_stem(frames_u8, sd, p, prec)
    for name, stride, proj in resnet_blocks(cfg["stage_sizes"]):
        y = bottleneck(y, sd, p + name, stride, proj, t, n_div, prec)
    return y.mean(dim=(2, 3))


# ---------------------------------------------------------------------------
# heads
# ---------------------------------------------------------------------------


def stacked_dense(sd, p, x, prec: Prec):
    """Per-window-position dense: x [B, W, in], weight [W, in, out]."""
    w = sd[p + "weight"]
    y = torch.stack([prec.matmul(x[:, i], w[i]) for i in range(w.shape[0])],
                    dim=1)
    return y + sd[p + "bias"][None]


def stacked_ln(sd, p, x, eps=1e-5):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return ((x - mean) * torch.rsqrt(var + eps) * sd[p + "weight"][None]
            + sd[p + "bias"][None])


def stacked_mlp(sd, p, x, n: int, prec: Prec):
    """[dense -> LN -> ReLU]* -> dense, per window position."""
    for i in range(n):
        x = stacked_dense(sd, f"{p}dense{i}.", x, prec)
        if i < n - 1:
            x = torch.relu(stacked_ln(sd, f"{p}ln{i}.", x))
    return x


def window_head(sd: Weights, p: str, lang, vision, cfg: dict,
                prec: Prec = FP32):
    """The window model's "mlp" fusion head and its stacked window
    attention (two_stream_window.py and stacked_window_self_attention.py
    of the reference repository) -> logits [B, 2].
    lang [B, W, 768], vision [B, W, T, 2048]."""
    b, w, seg = vision.shape[0], vision.shape[1], vision.shape[2]
    h = cfg["hidden_size"]
    fh = p + "fusion_head."
    lang_p = torch.relu(stacked_mlp(sd, fh + "lang_proj_heads.", lang, 2,
                                    prec))
    ve = vision.transpose(1, 2).reshape(b * seg, w, -1)
    vis = torch.relu(stacked_mlp(sd, fh + "vision_proj_heads.", ve, 3, prec))
    vis = vis.reshape(b, seg, w, h).transpose(1, 2)
    fused = torch.cat([vis, lang_p[:, :, None]], dim=2).reshape(b, w, -1)
    x = stacked_mlp(sd, fh + "head.", fused, 3, prec)
    wa = p + "window_attn."
    nh = cfg["window_heads"]
    hd = h // nh
    s = x.shape[1]
    for i in range(cfg["window_layers"]):
        q = f"{wa}block{i}."
        lin = lambda t, n: prec.linear(t, sd[q + n + ".weight"],  # noqa: E731
                                       sd[q + n + ".bias"])
        y = layer_norm(x, sd[q + "attention_norm.weight"],
                       sd[q + "attention_norm.bias"], 1e-5)
        middle = s // 2
        rel = ((torch.arange(s, device=x.device, dtype=x.dtype) - middle)
               / (middle + 1e-6))[:, None]
        y = y + lin(rel, "position_encoding")[None]
        heads = lambda t: t.reshape(b, s, nh, hd).transpose(1, 2)  # noqa: E731
        qh, kh, vh = (heads(lin(y, n)) for n in ("query", "key", "value"))
        att = prec.matmul(qh, kh.transpose(-1, -2)) / math.sqrt(hd)
        att = att + sd[q + "window_pos_bias"][..., :s]
        ctx = prec.matmul(torch.softmax(att, -1), vh)
        x = x + lin(ctx.transpose(1, 2).reshape(b, s, h), "out_proj")
        y = layer_norm(x, sd[q + "ffn_norm.weight"], sd[q + "ffn_norm.bias"],
                       1e-5)
        for j in range(4):
            y = lin(y, f"ffn{j}")
            if j < 3:
                y = F.gelu(y)
        x = x + y
    x = layer_norm(x, sd[wa + "final_layer_norm.weight"],
                   sd[wa + "final_layer_norm.bias"], 1e-5)
    y = x[:, s // 2]
    for j in range(4):
        y = prec.linear(y, sd[f"{wa}cls{j}.weight"], sd[f"{wa}cls{j}.bias"])
        y = F.gelu(layer_norm(y, sd[f"{wa}cls_ln{j}.weight"],
                              sd[f"{wa}cls_ln{j}.bias"], 1e-5))
    return prec.linear(y, sd[wa + "classifier.weight"],
                       sd[wa + "classifier.bias"])
