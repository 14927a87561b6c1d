"""The whole data-parallel train step's share of the dense bf16 peak of
every chip it uses: the reference's FLOPs of every rank's step (counted once
at a rank's shapes) times the untraced steps of the window, over their
seconds on the host's clock, against 989 TFLOP/s a chip."""

from benchmark import yardstick


def read(ctx):
    if ctx.kind != "train" or ctx.chips < 2 or ctx.rest_units <= 0 or not ctx.events:
        return None
    least = ctx.flops_per_unit * ctx.rest_units / (yardstick.PEAK_BF16_FLOPS * ctx.chips)
    return yardstick.share_pct(least, ctx.rest_s)
