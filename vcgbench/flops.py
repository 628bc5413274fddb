"""The benchmark's yardstick of work: operations and bytes from shapes,
and the H100's published peaks.

Copied so that it cannot move with the program:
- conv_macs, resnet_macs_per_frame, transformer_layer_macs,
  bert_encode_macs and the bf16 peak from
  video_chapter_generation_tpu_torch/utils/flops.py;
- bound, bound_sum and block_work from chip_smoke.py (a kernel's least
  time is max(operations / peak, bytes / 3.35 TB/s), each input read and
  each output written once, summed per shape).
Model FLOPs are 2 x MACs of the convolutions and matrix products
(elementwise work, norms and softmax left out).
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple

PEAK_BF16 = 989e12  # NVIDIA H100 SXM, dense bf16, at 700 W
PEAK_HBM = 3.35e12  # bytes/s


def conv_macs(h_out: int, w_out: int, cin: int, cout: int, k: int) -> int:
    return h_out * w_out * cin * cout * k * k


def resnet_macs_per_frame(hw: int = 224, stage_sizes=(3, 4, 6, 3)) -> int:
    """Conv MACs of one frame through the bottleneck trunk (4.09 G for
    ResNet-50 at 224 px); the shifts are free, no classifier."""
    total = 0
    h = hw // 2
    total += conv_macs(h, h, 3, 64, 7)
    h //= 2
    cin = 64
    for i, n_blocks in enumerate(stage_sizes):
        c = 64 * (2 ** i)
        cout = 4 * c
        for b in range(n_blocks):
            stride = 2 if (i > 0 and b == 0) else 1
            h_out = h // stride
            total += conv_macs(h, h, cin, c, 1)
            total += conv_macs(h_out, h_out, c, c, 3)
            total += conv_macs(h_out, h_out, c, cout, 1)
            if b == 0:
                total += conv_macs(h_out, h_out, cin, cout, 1)
            cin = cout
            h = h_out
    return total


def transformer_layer_macs(seq: int, d: int, ffn: int,
                           kv_seq: int = None) -> int:
    kv = seq if kv_seq is None else kv_seq
    attn_proj = 2 * seq * d * d + 2 * kv * d * d
    attn_einsum = 2 * seq * kv * d
    ffn_macs = 2 * seq * d * ffn
    return attn_proj + attn_einsum + ffn_macs


def bert_encode_macs(seq: int, layers: int = 12, d: int = 768,
                     ffn: int = 3072) -> int:
    return layers * transformer_layer_macs(seq, d, ffn)


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16
          ) -> Tuple[float, str]:
    """(least seconds on the card for this work, what bounds it)."""
    t_ops = flops / peak
    t_bytes = nbytes / PEAK_HBM
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def bound_sum(parts: Iterable[Tuple[float, float]], peak: float = PEAK_BF16
              ) -> float:
    """The sum of each part's bound, in seconds."""
    return sum(bound(f, b, peak)[0] for f, b in parts)


def block_work(nt, h, w, c, f, co, stride, proj):
    """(forward flops, activation rows in, rows out, weight count) of one
    bottleneck."""
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    m_in, m_out = nt * h * w, nt * ho * wo
    flops = 2 * (m_in * c * f + m_out * 9 * f * f + m_out * f * co
                 + (m_out * c * co if proj else 0))
    weights = c * f + 9 * f * f + f * co + (c * co if proj else 0)
    return flops, m_in, m_out, weights


# ---------------------------------------------------------------------------
# the trunk's parts at a call's shapes (bf16 activations and weights)
# ---------------------------------------------------------------------------


def trunk_parts(frames: int, hw: int, stage_sizes: Sequence[int],
                stem_input: str) -> list:
    """[(flops, bytes)] of one inference call over `frames` frames: the
    stem (uint8 s2d pixels in, or K6's uint8 -> bf16 normalization and a
    bf16 frame stem), then each bottleneck (its input, weights and output
    once each)."""
    hs = hw // 4
    stem_flops = 2 * frames * (hw // 2) ** 2 * 147 * 64
    stem_out = frames * hs * hs * 64 * 2
    parts = []
    if stem_input == "s2d":
        parts.append((stem_flops, frames * hw * hw * 3 + 147 * 64 * 2
                      + stem_out))
    else:
        px = frames * hw * hw * 3
        parts.append((0.0, px + 2 * px))  # K6: uint8 in, bf16 out
        parts.append((stem_flops, 2 * px + 147 * 64 * 2 + stem_out))
    h, c = hs, 64
    for i, n in enumerate(stage_sizes):
        f = 64 * 2 ** i
        for b in range(n):
            stride = 2 if i > 0 and b == 0 else 1
            fl, m_in, m_out, nw = block_work(frames, h, h, c, f, 4 * f,
                                             stride, b == 0)
            parts.append((fl, m_in * c * 2 + nw * 2 + m_out * 4 * f * 2))
            h = (h - 1) // stride + 1
            c = 4 * f
    return parts


def trunk_bound_s(frames: int, hw: int, stage_sizes: Sequence[int],
                  stem_input: str = "s2d") -> float:
    return bound_sum(trunk_parts(frames, hw, stage_sizes, stem_input))


def window_sample_flops(cfg: dict, hw: int) -> float:
    """Forward model FLOPs of one window sample (3 clips): BERT on each
    clip's text, the trunk on its frames (the head's share is under
    0.1% and left out)."""
    b, v = cfg["bert"], cfg["vision"]
    w = 2 * cfg["head"]["window_size"] + 1
    text = cfg["serving"]["max_text_len"]
    bert = bert_encode_macs(text, b["num_layers"], b["hidden_size"],
                            b["intermediate_size"]) + b["hidden_size"] ** 2
    trunk = v["n_segment"] * resnet_macs_per_frame(hw, v["stage_sizes"])
    return 2.0 * w * (bert + trunk)
