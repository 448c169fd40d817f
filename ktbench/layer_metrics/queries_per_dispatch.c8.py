"""Queries per dispatch in the eight-client cell: the session's
``requests_served`` over its ``batches_run``, as the clients' driver
counts them across the window and the profiled stretch (the warm
requests left out).  Above 1 where the clients' queries met in one
dispatch."""


def read(ctx):
    served, batches = getattr(ctx.driver, "served", 0), getattr(ctx.driver, "batches", 0)
    if not batches:
        return None
    return served / batches
