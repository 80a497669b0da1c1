"""Device ms per spatial training step on rank 0 in the halo exchanges and the
row gathers (all_gather): the program's span ``spatial.halo`` per call of
``train.step``, from CUDA events on the card's stream in the profiled
sub-window, waits on the other ranks included. None where the program has no
such span."""


def read(ctx):
    try:
        from partseg_tpu_torch import tracing
    except ImportError:   # a program without the span registry
        return None
    spans = tracing.snapshot()["spans"]
    part, per = spans.get("spatial.halo"), spans.get("train.step")
    if not part or not per or part["device_ms"] is None:
        return None
    return part["device_ms"] / per["calls"]
