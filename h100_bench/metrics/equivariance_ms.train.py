"""Device ms per training step in the equivariance and segmentation-consistency
terms: the program's span ``train.equivariance`` per call of ``train.step``,
from CUDA events on the card's stream in the profiled sub-window. None where
the program has no such span."""


def read(ctx):
    try:
        from partseg_tpu_torch import tracing
    except ImportError:   # a program without the span registry
        return None
    spans = tracing.snapshot()["spans"]
    part, per = spans.get("train.equivariance"), spans.get("train.step")
    if not part or not per or part["device_ms"] is None:
        return None
    return part["device_ms"] / per["calls"]
