"""The ``trip-load`` span per dispatch, in milliseconds, in the Delaunay
graph's cell: the host's time to queue the copies of a dispatch's inputs
and starting state into the trip graph's buffers."""


def read(ctx):
    span, dispatch = ctx.spans.get("trip-load"), ctx.spans.get("dispatch")
    if not span or not dispatch:
        return None
    return 1e3 * span[0] / dispatch[1]
