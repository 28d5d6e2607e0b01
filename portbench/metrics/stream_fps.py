"""Stream-frames whose tracks reached the host in the window, over its
seconds (host clock)."""


def read(ctx):
    return ctx.frames_done / ctx.window_s if ctx.window_s else None
