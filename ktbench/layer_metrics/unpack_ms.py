"""The ``unpack`` span per dispatch, in milliseconds: host time, ending in
the readback of what the members return."""


def read(ctx):
    span, dispatch = ctx.spans.get("unpack"), ctx.spans.get("dispatch")
    if not span or not dispatch:
        return None
    return 1e3 * span[0] / dispatch[1]
