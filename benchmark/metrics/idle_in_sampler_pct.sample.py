"""The share of the traced window in which the device is idle while the
host is inside the sampler: gaps with no device operation whose midpoint
falls inside a ``sample`` span's host interval, over the traced seconds.
The rest of ``device_idle_pct.sample`` is the caller's."""

from benchmark import program_spans


def read(ctx):
    if ctx.kind != "sample":
        return None
    idle = program_spans.idle_in(ctx, "sample")
    return None if idle is None else 100.0 * idle / ctx.traced_s
