"""Busy device ms a train step in D's object path (its first object block
through RoIAlign to the object and app scores), inside every D forward: the
kernel time inside the program's ``d.objects`` spans over the traced steps
(``program_spans``)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.ms_per_unit(ctx, "d.objects") if ctx.kind == "train" else None
