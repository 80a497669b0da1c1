"""The training window's share of the bf16 peak, on the reference's FLOPs per image."""


def read(ctx):
    return ctx.mfu()
