"""The nearest-rank 95th percentile of the sampled batches' latencies in
the untraced rest of the window, in ms: from a batch's dispatch until its
uint8 images are on the host (host clock). One batch is in flight, so the
loop runs at the sampler's capacity and this tail swings with the host."""

import math


def read(ctx):
    if ctx.kind != "sample" or not ctx.latencies:
        return None
    lat = sorted(ctx.latencies)
    return 1e3 * lat[max(0, math.ceil(0.95 * len(lat)) - 1)]
