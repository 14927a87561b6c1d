"""Rank 0's busy device ms a data-parallel train step in the gradient
all-reduces (one f32 buffer a network, waits for the other ranks
included): the device time inside the program's ``mesh.all_reduce`` spans
of kind ``grads`` (``program_spans``)."""

from benchmark import program_spans


def read(ctx):
    if ctx.kind != "train" or ctx.chips < 2:
        return None
    return program_spans.ms_per_unit(ctx, "mesh.all_reduce", kind="grads")
