"""Local mapping: mean ms a pass of the local BA (the program's span
``local_mapping.ba``: assembly, solve up to its fetch, the writes back),
over the slice's ``local_mapping.pass`` spans."""

from portbench import program_spans


def read(ctx):
    return program_spans.per_pass_ms(program_spans.records(), {"local_mapping.ba"})
