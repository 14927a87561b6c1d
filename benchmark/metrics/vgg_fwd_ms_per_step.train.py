"""Busy device ms a train step in the VGG19 loss's forward on both images:
the kernel time inside the program's ``train.vgg`` spans over the traced
steps (``program_spans``)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.ms_per_unit(ctx, "train.vgg") if ctx.kind == "train" else None
