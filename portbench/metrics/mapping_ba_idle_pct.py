"""Local mapping: the share of the local BA's time (the program's
``local_mapping.ba`` spans, put on the trace's clock by
``program_spans.alignment``) in which the card ran no kernel, copy or
set."""

from portbench import program_spans


def read(ctx):
    return program_spans.idle_pct(program_spans.records(), ctx.trace, "local_mapping.ba")
