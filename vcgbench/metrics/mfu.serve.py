"""The whole scoring step: model FLOPs of the clips scored in the window
over the window and the H100's 989 TFLOP/s bf16 peak, in %. A scored
clip counts BERT-base on the 100 tokens and ResNet50-TSM on the 16
frames of each of its window's 3 clips (vcgbench/flops.py). Padding
rows do not count."""

PEAK = 989e12


def read(ctx):
    w = ctx.get("window_s")
    work = ctx.get("clips", 0) * ctx.get("clip_flops", 0.0)
    return 100.0 * work / w / PEAK if w and work else None
