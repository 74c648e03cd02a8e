"""Local mapping: mean ms a pass of the stages before the local BA, from
the program's own spans (``multicol_slam_tpu_torch.utils.timing``): point
statistics, map-point culling, new points, cross-camera points and fuse,
their summed time over the slice's ``local_mapping.pass`` spans."""

from portbench import program_spans

STAGES = {"local_mapping." + s for s in
          ("point_stats", "cull_points", "new_points", "cross_camera", "fuse")}


def read(ctx):
    return program_spans.per_pass_ms(program_spans.records(), STAGES)
