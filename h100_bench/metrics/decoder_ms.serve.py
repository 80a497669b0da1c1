"""Device ms per request in the decoder: the program's span ``partnet.decoder``
per call of the request's span (``serve.infer`` or ``serve.transfer``), from
CUDA events on the card's stream in the profiled sub-window. None where the
program has no such span."""


def read(ctx):
    try:
        from partseg_tpu_torch import tracing
    except ImportError:   # a program without the span registry
        return None
    spans = tracing.snapshot()["spans"]
    part, per = spans.get("partnet.decoder"), spans.get(f"serve.{ctx.traffic['entry']}")
    if not part or not per or part["device_ms"] is None:
        return None
    return part["device_ms"] / per["calls"]
