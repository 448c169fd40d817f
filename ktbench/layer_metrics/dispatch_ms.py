"""The ``dispatch`` span per dispatch, in milliseconds: the peel, which
waits for the device (the fused loop reads back after every level, the
trip graph at its loop's exit)."""


def read(ctx):
    span, dispatch = ctx.spans.get("dispatch"), ctx.spans.get("dispatch")
    if not span or not dispatch:
        return None
    return 1e3 * span[0] / dispatch[1]
