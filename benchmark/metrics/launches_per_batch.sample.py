"""Kernel launches a sampled batch: kernels in the trace over the traced batches."""


def read(ctx):
    kernels = [e for e in ctx.events if e.kernel]
    if ctx.kind != "sample" or not kernels:
        return None
    return len(kernels) / ctx.traced_units
