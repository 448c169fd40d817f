"""The ``dispatch`` span per committed update, in milliseconds: the
frontier re-peel, which waits for the device."""


def read(ctx):
    span = ctx.spans.get("dispatch")
    if not span or not ctx.requests:
        return None
    return 1e3 * span[0] / ctx.requests
