"""Boundary scoring (pipeline/boundary.py, the pipeline's device stage):
StepTimer "device_score" seconds over the clips scored in the window,
in ms a clip (host clock; the stage ends in a host fetch, so it holds
the device time)."""


def read(ctx):
    st = (ctx.get("timer") or {}).get("device_score")
    return 1e3 * st["seconds"] / st["items"] if st and st["items"] else None
