"""The device in the traced sub-window: 1 - the seconds in which some
operation ran on it (kernels and copies, their union) / the sub-window,
in %."""


def read(ctx):
    dev = ctx.get("device")
    if not dev or not dev.get("window_s"):
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])
