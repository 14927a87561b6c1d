"""The ISLA backward's share of its bytes roofline in a train step: both of
its kernels (main and finishing) against the bytes of every backward call."""

from benchmark import yardstick


def read(ctx):
    if ctx.kind != "train":
        return None
    t = yardstick.seconds_where(ctx.events, lambda n: yardstick.ISLA_BACKWARD in n)
    if not t:
        return None
    nbytes = sum(yardstick.isla_backward_bytes(x, m, ctx.itemsize) for x, m in ctx.isla_calls)
    return yardstick.share_pct(nbytes / yardstick.HBM_BYTES_PER_S, t / ctx.traced_units)
