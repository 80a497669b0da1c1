"""Median ms the host takes to issue one request onto an idle card."""

import statistics


def read(ctx):
    return statistics.median(ctx.host_ms)
