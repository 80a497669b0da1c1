"""The spatial training window's share of the four cards' bf16 peak, on the
reference's FLOPs per 256 px image and the window's global images/s."""


def read(ctx):
    return ctx.mfu()
