"""The ``stream.delta``, ``stream.triangles`` and ``stream.frontier``
spans per committed update, in milliseconds: the stream layer's host time
around the re-peel."""

STAGES = ("stream.delta", "stream.triangles", "stream.frontier")


def read(ctx):
    found = [ctx.spans[s][0] for s in STAGES if s in ctx.spans]
    if not found or not ctx.requests:
        return None
    return 1e3 * sum(found) / ctx.requests
