"""The batch's move to the card (pipeline/boundary.py's window score
function, StepTimer "h2d": the frames, texts and masks, pageable): its
host seconds over the clips scored in the window, in ms a clip."""


def read(ctx):
    st = (ctx.get("timer") or {}).get("h2d")
    clips = ctx.get("clips")
    return 1e3 * st["seconds"] / clips if st and clips else None
