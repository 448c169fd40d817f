"""Edges re-peeled per committed update: ``stream_edges_repeeled`` over
``stream_updates``, over the whole traced process (warm updates, the
window and the stretch).  The wide deletes in the dense core set it."""

from ktbench.program_counters import ratio


def read(ctx):
    return ratio("stream_edges_repeeled", "stream_updates")
