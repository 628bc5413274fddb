"""Boundary scoring's device-driving thread waiting for the producer
(pipeline/boundary.py score_clips, StepTimer "queue_wait" around its
queue's get): those seconds over the window's wall-clock seconds, in %
(host clock)."""


def read(ctx):
    st = (ctx.get("timer") or {}).get("queue_wait")
    w = ctx.get("window_s")
    return 100.0 * st["seconds"] / w if st and w else None
