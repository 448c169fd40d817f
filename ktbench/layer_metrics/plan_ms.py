"""The port's ``plan`` spans (one per query, at submit), summed over the
window and divided by its dispatches: host milliseconds per dispatch.  A
span ends in ``plan``'s one readback, so it holds the device work queued
before it."""


def read(ctx):
    span, dispatch = ctx.spans.get("plan"), ctx.spans.get("dispatch")
    if not span or not dispatch:
        return None
    return 1e3 * span[0] / dispatch[1]
