"""``dispatch_device_ms``, read as its own reader reads it, in the Delaunay
graph's cell, where each dispatch is one replay of the unfused trip graph."""

from ktbench.spec import load_reader


def read(ctx):
    return load_reader("layer_metrics", "dispatch_device_ms").read(ctx)
