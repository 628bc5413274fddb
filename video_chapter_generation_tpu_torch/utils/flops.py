"""Analytic model-FLOP counts for utilization figures (counterpart of the
JAX package's utils/flops.py).

Model FLOPs are computed from the architecture: conv and matmul MACs x 2,
elementwise, BN and softmax work left out (the usual model-FLOP
convention); a backward pass counts as 2x the forward. `mfu` divides a
measured FLOP rate by a peak. The peaks are NVIDIA's published dense
figures for the H100 SXM (NVIDIA H100 80GB HBM3 at 700 W): 989 TFLOP/s
bf16 and 1,979 TOP/s int8, the ones chip_smoke.py's bounds use; a card
set to a lower power limit reaches less.

The MAC counts are the port's own copies of the JAX package's (each
names the line it was copied from).
"""

from __future__ import annotations

PEAK_BF16 = 989e12  # H100 SXM, dense bf16
PEAK_INT8 = 1979e12  # H100 SXM, dense int8


def conv_macs(h_out: int, w_out: int, cin: int, cout: int, k: int) -> int:
    """Copied from video_chapter_generation_tpu/utils/flops.py:21."""
    return h_out * w_out * cin * cout * k * k


def resnet_macs_per_frame(hw: int = 224, depth: int = 50,
                          stage_sizes=None) -> int:
    """Conv MACs of one frame through the (bottleneck) ResNet trunk —
    TSM shifts are free, no fc in the embedder. Validated against the
    canonical ResNet-50 count (~4.09 GMACs at 224px).

    Copied from video_chapter_generation_tpu/utils/flops.py:25."""
    if stage_sizes is None:
        stage_sizes = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}[depth]
    total = 0
    # stem: 7x7/2 3->64 (the fused s2d stem computes the same math)
    h = hw // 2
    total += conv_macs(h, h, 3, 64, 7)
    h //= 2  # maxpool -> hw/4
    cin = 64
    for i, n_blocks in enumerate(stage_sizes):
        c = 64 * (2 ** i)
        cout = 4 * c
        for b in range(n_blocks):
            stride = 2 if (i > 0 and b == 0) else 1
            h_out = h // stride
            # v1.5: stride sits on the 3x3, so the 1x1 reduce runs at the
            # INPUT resolution (models/resnet.py Bottleneck)
            total += conv_macs(h, h, cin, c, 1)              # 1x1 reduce
            total += conv_macs(h_out, h_out, c, c, 3)        # 3x3 (stride)
            total += conv_macs(h_out, h_out, c, cout, 1)     # 1x1 expand
            if b == 0:
                total += conv_macs(h_out, h_out, cin, cout, 1)  # downsample
            cin = cout
            h = h_out
    return total


def transformer_layer_macs(seq: int, d: int, ffn: int,
                           kv_seq: int = None) -> int:
    """One encoder-style layer: QKV+O projections + attention einsums +
    FFN. kv_seq != seq models cross-attention key/value length.

    Copied from video_chapter_generation_tpu/utils/flops.py:56."""
    kv = seq if kv_seq is None else kv_seq
    attn_proj = 2 * seq * d * d + 2 * kv * d * d  # q,o at seq; k,v at kv
    attn_einsum = 2 * seq * kv * d                # scores + context
    ffn_macs = 2 * seq * d * ffn
    return attn_proj + attn_einsum + ffn_macs


def bert_encode_macs(seq: int, layers: int = 12, d: int = 768,
                     ffn: int = 3072) -> int:
    """Copied from video_chapter_generation_tpu/utils/flops.py:67."""
    return layers * transformer_layer_macs(seq, d, ffn)


def seq2seq_macs(enc_len: int, dec_len: int, enc_layers: int,
                 dec_layers: int, d: int, ffn: int, vocab: int) -> int:
    """Teacher-forced forward of the Pegasus-style model: encoder stack,
    decoder self+cross attention stack, tied vocab head.

    Copied from video_chapter_generation_tpu/utils/flops.py:72."""
    enc = enc_layers * transformer_layer_macs(enc_len, d, ffn)
    dec_self = dec_layers * (4 * dec_len * d * d + 2 * dec_len * dec_len * d)
    dec_cross = dec_layers * (2 * dec_len * d * d + 2 * enc_len * d * d
                              + 2 * dec_len * enc_len * d)
    dec_ffn = dec_layers * 2 * dec_len * d * ffn
    head = dec_len * d * vocab
    return enc + dec_self + dec_cross + dec_ffn + head


def mfu(flops_per_sec: float, peak: float = PEAK_BF16) -> float:
    """A measured FLOP rate as a share of the peak."""
    return flops_per_sec / peak
