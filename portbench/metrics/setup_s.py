"""Seconds from the process's start to the window's first frame: imports,
weights, clips, kernel builds on a checkout's first run, warm-up and
capture (host clock)."""


def read(ctx):
    return ctx.setup_s
