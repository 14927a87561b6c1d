"""Busy device ms a train step in the backwards of D's and G's losses: the
kernel time inside the program's ``train.backward`` spans over the traced
steps (``program_spans``)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.ms_per_unit(ctx, "train.backward") if ctx.kind == "train" else None
