"""softmax_moments' share of its roofline in a request: one launch per shape
encoding (infer: 1, transfer: the shape and the appearance images, 2) over
the device time of the kernel."""

from h100_bench.peaks import bound_ms, softmax_moments_bound

KERNELS = ("softmax_moments_kernel",)
ENCODINGS = {"infer": 1, "transfer": 2}


def read(ctx):
    m, b = ctx.config["model"], int(ctx.traffic["batch"])
    side = m["img_size"] // m["stem_stride"] * (2 if m["head_upsample"] else 1)
    bound = bound_ms(*softmax_moments_bound(b, side, side, m["n_parts"]))[0]
    return ctx.roofline(KERNELS, ENCODINGS[ctx.traffic["entry"]] * bound)
