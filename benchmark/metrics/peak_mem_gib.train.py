"""The caching allocator's peak of allocated bytes over the window, in GiB."""


def read(ctx):
    if ctx.kind != "train" or ctx.peak_window_bytes is None:
        return None
    return ctx.peak_window_bytes / 2**30
