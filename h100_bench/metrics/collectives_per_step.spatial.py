"""Collective calls per spatial training step on rank 0: the program's
counters ``spatial.halo``, ``spatial.reduce`` and ``dist.grad_reduce`` over
the profiled sub-window (the driver's difference of the counters around it)
per call of the span ``train.step`` there. None where the program lacks one
of them."""

NAMES = ("spatial.halo", "spatial.reduce", "dist.grad_reduce")


def read(ctx):
    counted = getattr(ctx.traced, "counters", None)
    if counted is None or any(counted.get(n, 0) == 0 for n in NAMES):
        return None
    from partseg_tpu_torch import tracing

    per = tracing.snapshot()["spans"].get("train.step")
    if not per:
        return None
    return sum(counted[n] for n in NAMES) / per["calls"]
