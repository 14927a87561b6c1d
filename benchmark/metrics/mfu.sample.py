"""The whole sampled batch (G forward)'s share of the card's dense bf16 peak: the
reference's FLOPs a batch (counted once at the cell's shapes) times the
untraced batches of the window, over their seconds on the host's clock,
against 989 TFLOP/s."""

from benchmark import yardstick


def read(ctx):
    if ctx.kind != "sample" or ctx.rest_units <= 0 or not ctx.events:
        return None
    least = ctx.flops_per_unit * ctx.rest_units / yardstick.PEAK_BF16_FLOPS
    return yardstick.share_pct(least, ctx.rest_s)
