"""Device ms per request in GroupNorm, elementwise and copy kernels."""


def read(ctx):
    return ctx.traced.category_ms(("group_norm", "elementwise_copy"))
