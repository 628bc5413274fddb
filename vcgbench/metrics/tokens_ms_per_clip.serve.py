"""The producer's text encoding (data/datasets.py InferWindowClipDataset,
each clip of a window through the WordPiece tokenizer): StepTimer
"tokens" seconds over the clips scored in the window, in ms a clip
(host clock)."""


def read(ctx):
    st = (ctx.get("timer") or {}).get("tokens")
    clips = ctx.get("clips")
    return 1e3 * st["seconds"] / clips if st and clips else None
