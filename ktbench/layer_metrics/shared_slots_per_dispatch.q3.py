"""Members a dispatch holds on a graph an earlier member of it also holds,
in the shared-queries cell: the planner's ``peel_slots_shared`` over its
``peel_batches`` (summed over its label sets), over the whole traced
process.  2.0 where each request's three queries on one graph meet in one
dispatch.  ``None`` for a program that does not count shared members."""

from ktbench.counter_sums import summed


def read(ctx):
    shared, batches = summed("peel_slots_shared"), summed("peel_batches")
    if shared is None or not batches:
        return None
    return shared / batches
