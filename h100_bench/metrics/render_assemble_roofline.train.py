"""render_assemble's share of its roofline in a training step: the bound of
every forward and backward launch (one decode of each scale, and a second
with the appearance-swap term) over the device time of the kernels named."""

from h100_bench.peaks import bound_ms, decoder_scales, render_assemble_bound, render_backward_bound

KERNELS = ("render_assemble_kernel", "render_assemble_bwd_tiled", "render_assemble_bwd_finish")


def read(ctx):
    m, b = ctx.config["model"], int(ctx.traffic["batch"])
    decodes = 1 + bool(ctx.config["loss"]["swap_weight"])
    per_decode = sum(bound_ms(*render_assemble_bound(b, m["n_parts"], f, res))[0]
                     + bound_ms(*render_backward_bound(b, m["n_parts"], f, res))[0]
                     for res, f in decoder_scales(m))
    return ctx.roofline(KERNELS, decodes * per_decode)
