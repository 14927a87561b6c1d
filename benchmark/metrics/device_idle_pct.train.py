"""The share of the traced train steps in which no operation ran on the
device: 1 - (union of device intervals / traced window)."""

from benchmark import yardstick


def read(ctx):
    if ctx.kind != "train" or not ctx.events:
        return None
    return 100.0 * (1.0 - yardstick.busy_seconds(ctx.events) / ctx.traced_s)
