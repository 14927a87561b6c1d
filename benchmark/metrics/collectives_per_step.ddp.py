"""Collectives a data-parallel train step on rank 0: the program's
``mesh.all_reduce`` spans, every kind, over the traced steps."""

from benchmark import program_spans


def read(ctx):
    if ctx.kind != "train" or ctx.chips < 2:
        return None
    return program_spans.spans_per_unit(ctx, "mesh.all_reduce")
