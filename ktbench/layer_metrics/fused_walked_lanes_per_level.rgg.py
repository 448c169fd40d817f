"""``fused_walked_lanes_per_level``, read as its own reader reads it, in the random geometric
graph's cell, whose slots are twice as wide as the Kronecker cell's."""

from ktbench.spec import load_reader


def read(ctx):
    return load_reader("layer_metrics", "fused_walked_lanes_per_level").read(ctx)
