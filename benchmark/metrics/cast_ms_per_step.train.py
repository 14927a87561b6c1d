"""Busy device ms a train step in the bf16 casts of G's and D's parameters
(three a mixed step): the kernel time inside the program's ``train.cast``
spans over the traced steps (``program_spans``)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.ms_per_unit(ctx, "train.cast") if ctx.kind == "train" else None
