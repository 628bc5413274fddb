"""The one flow of the cell, paced by the host (the producer thread of
pipeline/boundary.py's score_clips decodes and stacks each batch):
seconds of video scored over the window's wall-clock seconds, in s/s."""


def read(ctx):
    w = ctx.get("window_s")
    return ctx["video_s"] / w if w and ctx.get("video_s") else None
