"""Kernel launches a train step: kernels in the trace over the traced steps."""


def read(ctx):
    kernels = [e for e in ctx.events if e.kernel]
    if ctx.kind != "train" or not kernels:
        return None
    return len(kernels) / ctx.traced_units
