"""Median ms rank 0's host takes to issue one spatial training step onto an
idle card (every rank runs the step; rank 0 times it)."""

import statistics


def read(ctx):
    return statistics.median(ctx.host_ms)
