"""The producer's copies of decoded frames: from the cache into each
window (data/datasets.py InferWindowClipDataset, StepTimer "frames" self
seconds, the decodes under it left out) and of the windows into the
batch (data/loader.py collate, "collate" seconds), over the clips scored
in the window, in ms a clip (host clock)."""


def read(ctx):
    timer = ctx.get("timer") or {}
    frames, collate = timer.get("frames"), timer.get("collate")
    clips = ctx.get("clips")
    if not (frames and collate and clips):
        return None
    return 1e3 * (frames["self_seconds"] + collate["seconds"]) / clips
