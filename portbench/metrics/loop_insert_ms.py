"""Loop closing: mean ms of the loop closer's insertion of a keyframe (the
program's ``loop_closing.insert`` spans over the slice)."""

from portbench import program_spans


def read(ctx):
    return program_spans.mean_ms(program_spans.records(), "loop_closing.insert")
