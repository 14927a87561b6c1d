"""The median host ms of a sampled batch's dispatch: the program's ``sample``
spans over the traced batches, from the call until it returns the images'
tensor (the caller's uint8 copy to the host is outside)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.median_host_ms(ctx, "sample") if ctx.kind == "sample" else None
