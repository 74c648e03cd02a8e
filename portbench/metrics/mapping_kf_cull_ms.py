"""Local mapping: mean ms a pass of keyframe culling (the program's span
``local_mapping.cull_keyframes``), over the slice's ``local_mapping.pass``
spans."""

from portbench import program_spans


def read(ctx):
    return program_spans.per_pass_ms(program_spans.records(),
                                     {"local_mapping.cull_keyframes"})
