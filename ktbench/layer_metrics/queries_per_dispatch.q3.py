"""Queries per dispatch in the shared-queries cell: the planner's
``peel_slots`` (each dispatch's members) over its ``peel_batches`` (its
dispatches), each summed over its label sets, over the whole traced
process.  3.0 where each request's three queries meet in one dispatch."""

from ktbench.counter_sums import summed


def read(ctx):
    slots, batches = summed("peel_slots"), summed("peel_batches")
    if slots is None or not batches:
        return None
    return slots / batches
