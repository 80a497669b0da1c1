"""% of the profiled serving sub-window in which no operation ran on the card."""


def read(ctx):
    return ctx.idle_share()
