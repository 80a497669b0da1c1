"""Device ms per training step in convolution and matrix-product kernels."""


def read(ctx):
    return ctx.traced.category_ms(("conv_matmul",))
