"""Device ms a train step in the frozen "convolutions (cuDNN)" kernel class."""

from benchmark import yardstick


def read(ctx):
    if ctx.kind != "train":
        return None
    s = yardstick.class_seconds(ctx.events).get("convolutions (cuDNN)")
    return None if not s else 1e3 * s / ctx.traced_units
