"""The producer's JPEG decode (data/frames.py FrameCache.get, a frame on
each miss): StepTimer "decode" self seconds over the clips scored in the
window, in ms a clip (host clock)."""


def read(ctx):
    st = (ctx.get("timer") or {}).get("decode")
    clips = ctx.get("clips")
    return 1e3 * st["self_seconds"] / clips if st and clips else None
