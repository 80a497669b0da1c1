"""% of rank 0's profiled spatial training sub-window in which no operation
ran on its card (NCCL's kernels count as busy, their waits on the other
ranks included)."""


def read(ctx):
    return ctx.idle_share()
