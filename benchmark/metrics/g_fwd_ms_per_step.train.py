"""Busy device ms a train step in G's forward: the kernel time inside the
device intervals of the program's ``train.g_forward`` spans, over the
traced steps (``program_spans``: the card's waits for dispatch left out)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.ms_per_unit(ctx, "train.g_forward") if ctx.kind == "train" else None
