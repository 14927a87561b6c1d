"""Busy device ms a train step in D's forwards, every role (real, fake,
fused, for G's loss): the kernel time inside the program's
``train.d_forward`` spans over the traced steps (``program_spans``)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.ms_per_unit(ctx, "train.d_forward") if ctx.kind == "train" else None
