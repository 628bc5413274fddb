"""The inference trunk's kernels (ops/stem.py, ops/tsm_block.py,
ops/preprocess.py -> csrc/stem_s2d.cu, tsm_bottleneck.cu, frame_ops.cu)
in the traced sub-window: the least time of the trunk work they did
(one vision call's bound from its shapes, vcgbench/flops.py, times the
stem launches seen, one a call) over the device time of the trunk's
kernels, found by name, in %."""

STEM = "stem_kernel"
# the trunk's kernels (csrc/stem_s2d.cu, tsm_bottleneck.cu, tsm_conv.cu,
# frame_ops.cu), by name
TRUNK = ("stem_kernel", "conv_kernel", "pair_kernel", "tsm_conv1x1_kernel",
         "normalize_kernel")


def read(ctx):
    calls = busy = 0.0
    for s, e, name in ctx.get("events") or []:
        if STEM in name:
            calls += 1
        if any(p in name for p in TRUNK):
            busy += (e - s) / 1e9
    if not calls or not busy:
        return None
    return 100.0 * calls * ctx["trunk_call_bound_s"] / busy
