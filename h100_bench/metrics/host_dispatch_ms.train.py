"""Median ms the host takes to issue one training step onto an idle card."""

import statistics


def read(ctx):
    return statistics.median(ctx.host_ms)
