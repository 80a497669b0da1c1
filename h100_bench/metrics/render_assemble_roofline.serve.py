"""render_assemble's share of its roofline in a transfer request: the bound of
one decode's forward launches over the device time of the forward kernel."""

from h100_bench.peaks import bound_ms, decoder_scales, render_assemble_bound

KERNELS = ("render_assemble_kernel",)


def read(ctx):
    m, b = ctx.config["model"], int(ctx.traffic["batch"])
    return ctx.roofline(KERNELS, sum(bound_ms(*render_assemble_bound(b, m["n_parts"], f, res))[0]
                                     for res, f in decoder_scales(m)))
