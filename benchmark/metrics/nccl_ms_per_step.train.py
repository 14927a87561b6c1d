"""Rank 0's device ms a train step in NCCL's kernels: the collectives of a
data-parallel step (BN statistics, gradients, metrics)."""

from benchmark import yardstick


def read(ctx):
    if ctx.kind != "train" or ctx.chips < 2:
        return None
    s = yardstick.seconds_where(ctx.events, lambda n: "nccl" in n.lower())
    return None if not s else 1e3 * s / ctx.traced_units
