"""Rank 0's share of the traced data-parallel train steps in which no
operation ran on its device: 1 - (union of device intervals / traced window)."""

from benchmark import yardstick


def read(ctx):
    if ctx.kind != "train" or ctx.chips < 2 or not ctx.events:
        return None
    return 100.0 * (1.0 - yardstick.busy_seconds(ctx.events) / ctx.traced_s)
