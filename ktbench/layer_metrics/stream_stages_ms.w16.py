"""``stream_stages_ms``, read as its own reader reads it, in the width-16
stream cell, where each update applies 8 deletes and 8 inserts."""

from ktbench.spec import load_reader


def read(ctx):
    return load_reader("layer_metrics", "stream_stages_ms").read(ctx)
