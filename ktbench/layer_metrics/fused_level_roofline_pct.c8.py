"""``fused_level_roofline_pct``, read as its own reader reads it, in the eight-client
cell, where one dispatch holds several live slots."""

from ktbench.spec import load_reader


def read(ctx):
    return load_reader("layer_metrics", "fused_level_roofline_pct").read(ctx)
