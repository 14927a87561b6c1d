"""Busy device ms a train step in the optimizers: the kernel time inside the
program's ``train.adam`` spans (D and G) and ``train.ema`` spans, over the
traced steps (``program_spans``)."""

from benchmark import program_spans


def read(ctx):
    if ctx.kind != "train":
        return None
    parts = [program_spans.ms_per_unit(ctx, n) for n in ("train.adam", "train.ema")]
    return None if parts[0] is None else parts[0] + (parts[1] or 0.0)
