"""The serving window's share of the bf16 peak, on the reference's forward FLOPs per image."""


def read(ctx):
    return ctx.mfu()
