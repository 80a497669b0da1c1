"""Device ms per spatial training step on rank 0 in GroupNorm, elementwise
and copy kernels (the spatial path's GroupNorm runs in plain f32)."""


def read(ctx):
    return ctx.traced.category_ms(("group_norm", "elementwise_copy"))
