"""``dispatch_ms.stream``, read as its own reader reads it, in the width-16
stream cell, where each update re-peels its frontier in one dispatch."""

from ktbench.spec import load_reader


def read(ctx):
    return load_reader("layer_metrics", "dispatch_ms.stream").read(ctx)
