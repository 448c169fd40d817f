"""``fused_level_roofline_pct``, read as its own reader reads it, in the random geometric
graph's cell, where every row is short and a decompose has few levels."""

from ktbench.spec import load_reader


def read(ctx):
    return load_reader("layer_metrics", "fused_level_roofline_pct").read(ctx)
