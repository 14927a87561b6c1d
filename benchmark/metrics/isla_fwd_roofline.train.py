"""The ISLA forward kernel's share of its bytes roofline in a train step:
the least time its calls' bytes need at the HBM peak over the summed time
of its launches. Bytes only: the data-dependent work is not visible."""

from benchmark import yardstick


def read(ctx):
    if ctx.kind != "train":
        return None
    t = yardstick.seconds_where(ctx.events, lambda n: yardstick.ISLA_FORWARD in n)
    if not t:
        return None
    nbytes = sum(yardstick.isla_forward_bytes(x, m, ctx.itemsize) for x, m in ctx.isla_calls)
    return yardstick.share_pct(nbytes / yardstick.HBM_BYTES_PER_S, t / ctx.traced_units)
