"""Rank 0's busy device ms a data-parallel train step in the global BN
statistics' all-reduces, forward and backward: the device time inside the
program's ``mesh.all_reduce`` spans of kind ``bn_sum`` (``program_spans``),
so NCCL's kernels, waits for the other ranks included."""

from benchmark import program_spans


def read(ctx):
    if ctx.kind != "train" or ctx.chips < 2:
        return None
    return program_spans.ms_per_unit(ctx, "mesh.all_reduce", kind="bn_sum")
