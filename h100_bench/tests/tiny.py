"""A cell's spec cut to a size the CPU runs in seconds, for the tests."""

from __future__ import annotations

import copy

from h100_bench import run as bench

TINY_MODEL = dict(img_size=16, features=16, depth=1, app_features=16, decoder_scales=2,
                  decoder_features=[16, 8], n_parts=4, dtype="float32")
TINY_LOSS = dict(vgg_layers=["relu1_2"], vgg_trim_blocks=1, vgg_resolution=None)
TINY_TRAFFIC = dict(batch=4, pool=3, check_rows=2, trace_units=2, trace_seconds=0.0,
                    host_dispatch_calls=2, check_requests=2, warmup=1)


def shrink(spec: bench.Spec) -> bench.Spec:
    """``spec`` at a tiny width, float32, with small batches (in place)."""
    spec.config["model"].update(TINY_MODEL)
    spec.config["loss"].update(TINY_LOSS)
    spec.traffic.update({k: v for k, v in TINY_TRAFFIC.items() if k in spec.traffic})
    return spec


def spec(cell: str) -> bench.Spec:
    return shrink(copy.deepcopy(bench.load_spec(cell)))
