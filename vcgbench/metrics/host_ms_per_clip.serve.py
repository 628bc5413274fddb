"""The producer of boundary scoring (the thread of pipeline/boundary.py's
score_clips that runs data/datasets.py, data/frames.py and
data/loader.py): StepTimer "host_load" seconds, each batch assembled,
over the clips scored in the window, in ms a clip (host clock)."""


def read(ctx):
    st = (ctx.get("timer") or {}).get("host_load")
    clips = ctx.get("clips")
    return 1e3 * st["seconds"] / clips if st and clips else None
