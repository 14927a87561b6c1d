"""Device ms a train step in cuDNN's NCHW<->NHWC transposes."""

from benchmark import yardstick


def read(ctx):
    if ctx.kind != "train":
        return None
    s = yardstick.class_seconds(ctx.events).get("cuDNN layout transposes")
    return None if not s else 1e3 * s / ctx.traced_units
