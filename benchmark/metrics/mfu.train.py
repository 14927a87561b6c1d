"""The whole train step's share of the card's dense bf16 peak: the
reference's FLOPs a step (counted once at the cell's shapes) times the
untraced steps of the window, over their seconds on the host's clock,
against 989 TFLOP/s a chip (a data-parallel step's FLOPs are every rank's)."""

from benchmark import yardstick


def read(ctx):
    if ctx.kind != "train" or ctx.rest_units <= 0 or not ctx.events:
        return None
    least = ctx.flops_per_unit * ctx.rest_units / (yardstick.PEAK_BF16_FLOPS * ctx.chips)
    return yardstick.share_pct(least, ctx.rest_s)
